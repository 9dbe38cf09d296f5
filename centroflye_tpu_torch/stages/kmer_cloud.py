"""Per-read k-mer clouds: one set of (selected) k-mers per unit instance.
Host numpy, a copy of the JAX package's `stages/kmer_cloud.py`.

Reference behavior (read_kmer_cloud.py:17-54): for each unit instance of a
read's tandem alignment, the set of its k-mers that belong to a given
genomic k-mer set; filter_reads_kmer_clouds then drops k-mers whose total
multiplicity across all (read, instance) sets is below min_mult.

Array-native representation: each cloud is a row of int32 indices into the
sorted genomic-k-mer table (-1 padded), stacked as (n_instances_total, K)
with per-read instance offsets — directly consumable by the distance-graph
stage on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from centroflye_tpu_torch.io.encoding import encode, kmer_codes


@dataclasses.dataclass
class ReadClouds:
    """Clouds for one read: clouds[i] = sorted unique indices (into the
    genomic k-mer table) present in unit instance i."""

    r_id: str
    clouds: List[np.ndarray]

    @property
    def n_units(self) -> int:
        return len(self.clouds)

    def all_indices(self) -> np.ndarray:
        if not self.clouds:
            return np.empty(0, np.int64)
        return np.concatenate(self.clouds)


def build_read_clouds(
    records,                      # Dict[str, DecompRecord]
    genomic_codes: np.ndarray,    # sorted uint64 k-mer codes
    k: int,
) -> Dict[str, ReadClouds]:
    """Clouds for every record (reference read_kmer_cloud.py:34-40)."""
    out: Dict[str, ReadClouds] = {}
    for r_id, rec in records.items():
        clouds = []
        seq_codes = encode(rec.seq)
        codes, valid = kmer_codes(seq_codes, k)
        # which windows hit the genomic table
        pos = np.searchsorted(genomic_codes, codes)
        pos_c = np.minimum(pos, max(len(genomic_codes) - 1, 0))
        found = valid if len(genomic_codes) == 0 else (
            valid & (genomic_codes[pos_c] == codes))
        for i in range(rec.n_units):
            st, en = int(rec.bounds[i]), int(rec.bounds[i + 1])
            # windows fully inside [st, en): start in [st, en - k]
            w_en = min(en - k + 1, len(codes))
            if w_en <= st:
                clouds.append(np.empty(0, np.int64))
                continue
            sel = found[st:w_en]
            idx = np.unique(pos_c[st:w_en][sel])
            clouds.append(idx.astype(np.int64))
        out[r_id] = ReadClouds(r_id=r_id, clouds=clouds)
    return out


def filter_read_clouds(
    clouds: Dict[str, ReadClouds],
    min_mult: int = 2,
    max_mult: float = float("inf"),
) -> Dict[str, ReadClouds]:
    """Drop k-mers whose multiplicity across all (read, instance) sets is
    outside [min_mult, max_mult] (reference read_kmer_cloud.py:43-54)."""
    counts: Dict[int, int] = {}
    all_counts = np.zeros(0, np.int64)
    max_idx = -1
    for rc in clouds.values():
        for c in rc.clouds:
            if len(c):
                max_idx = max(max_idx, int(c.max()))
    mult = np.zeros(max_idx + 1, np.int64)
    for rc in clouds.values():
        for c in rc.clouds:
            mult[c] += 1
    out: Dict[str, ReadClouds] = {}
    for r_id, rc in clouds.items():
        new_clouds = []
        for c in rc.clouds:
            if len(c) == 0:
                new_clouds.append(c)
                continue
            m = mult[c]
            keep = (m >= min_mult) & (m <= max_mult)
            new_clouds.append(c[keep])
        out[r_id] = ReadClouds(r_id=r_id, clouds=new_clouds)
    return out


def pad_clouds(
    clouds: Dict[str, ReadClouds],
    order: Optional[Sequence[str]] = None,
) -> Tuple[List[str], np.ndarray, np.ndarray, int]:
    """Dense device layout: (r_ids, cloud_tensor (R, T, K) int32 with -1
    padding, n_units (R,) int32, K). T = max instances, K = max kmers per
    cloud."""
    r_ids = list(order) if order is not None else list(clouds.keys())
    T = max((clouds[r].n_units for r in r_ids), default=0)
    K = max((len(c) for r in r_ids for c in clouds[r].clouds), default=0)
    K = max(K, 1)
    tensor = np.full((len(r_ids), T, K), -1, dtype=np.int32)
    n_units = np.zeros(len(r_ids), dtype=np.int32)
    for ri, r_id in enumerate(r_ids):
        rc = clouds[r_id]
        n_units[ri] = rc.n_units
        for t, c in enumerate(rc.clouds):
            tensor[ri, t, :len(c)] = c
    return r_ids, tensor, n_units, K
