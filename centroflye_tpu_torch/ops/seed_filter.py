"""Seed prefilter for read recruitment, as the JAX package's
`ops/seed_filter.py`: host numpy tables (`build_seed_table`,
`build_seed_bitmap`), the host prescan, and the device hit counts
(`seed_hit_counts_bitmap`, `seed_hit_counts`) in plain PyTorch.

The recruitment decision is overwhelmingly negative on real data, so a
cheap exact-membership seed scan runs before the Myers alignment: rows
with too few unit seed k-mer hits cannot hold a unit alignment within the
threshold. `RecruitmentConfig.prefilter=False` gives the pure-Myers exact
path for parity runs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from centroflye_tpu_torch.io.encoding import (encode, kmer_codes,
                                              revcomp_str, split_u64)
from centroflye_tpu_torch.ops.kmers import lookup_codes, pack_kmers


def build_seed_table(unit: str, k: int = 13) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """Sorted (hi, lo) uint32 table of the unit's seed k-mers, both
    strands, over the doubled unit (instance-crossing seeds included)."""
    seqs = [unit + unit[:k - 1], revcomp_str(unit + unit[:k - 1])]
    codes = []
    for s in seqs:
        c, valid = kmer_codes(encode(s), k)
        codes.append(c[valid])
    return split_u64(np.unique(np.concatenate(codes)))


def build_seed_bitmap(unit: str, k: int = 13, *, le: bool = False
                      ) -> np.ndarray:
    """Direct-address membership bitmap over all 4^k k-mers (k <= 15:
    4^13 = 8 MB of bits as uint32[4^k / 32]) of the unit's seed k-mers,
    both strands, over the doubled unit (instance-crossing seeds included).

    le=True keys the bitmap by LITTLE-endian codes (first base in the low
    2 bits): the natural order of k-mers read straight from 2-bit packed
    bytes (ops/fused_recruit packed filter path)."""
    assert k <= 15, "direct-address bitmap needs k <= 15"
    seqs = [unit + unit[:k - 1], revcomp_str(unit + unit[:k - 1])]
    bitmap = np.zeros(4 ** k // 32, dtype=np.uint32)
    for s in seqs:
        c, valid = kmer_codes(encode(s), k)
        c = c[valid].astype(np.uint64)
        if le:
            r = np.zeros_like(c)
            for i in range(k):
                r |= (((c >> np.uint64(2 * i)) & np.uint64(3))
                      << np.uint64(2 * (k - 1 - i)))
            c = r
        # collision-safe scatter-OR: fancy-index `|=` is last-write-wins
        # on duplicate word indices and silently drops bits
        np.bitwise_or.at(
            bitmap, (c >> np.uint64(5)).astype(np.int64),
            np.uint32(1) << (c & np.uint64(31)).astype(np.uint32))
    return bitmap


def host_prescan_hits(packed: np.ndarray, lens: np.ndarray,
                      bitmap_le: np.ndarray, k: int = 13) -> np.ndarray:
    """Host stage-A seed prescan over 2-bit packed rows.

    Samples ONE k-mer per 16-base u32 word (in-word phase 0) and counts
    membership in the LE-keyed seed bitmap: the device packed filter
    restricted to offset 0 (ops/fused_recruit). Rows with 0 sampled hits
    resolve as non-centromeric before upload. Rows holding in-range N
    bases must NOT be prescanned (N packs as base 0): they go to the exact
    Myers tier instead.
    """
    B, Lq = packed.shape
    assert Lq % 4 == 0
    W = packed.reshape(B, Lq // 4, 4).view(np.uint32)[..., 0]
    code = W & np.uint32((1 << (2 * k)) - 1)
    pos16 = 16 * np.arange(Lq // 4, dtype=np.int32)[None, :]
    valid = (pos16 + k) <= np.asarray(lens, np.int32)[:, None]
    got = bitmap_le[(code >> np.uint32(5)).astype(np.int64)]
    found = (((got >> (code & np.uint32(31))) & 1) == 1) & valid
    return found.sum(axis=1, dtype=np.int32)


def seed_hit_counts_bitmap(bitmap: torch.Tensor, codes: torch.Tensor,
                           lens: torch.Tensor, *, k: int, stride: int = 1):
    """Per-row count of read k-mers present in the seed bitmap (int64
    tensor of 32-bit words, `build_seed_bitmap`), sampling every
    `stride`-th position. codes: (B, L) int8 -> (B,) int32 hit counts.

    The bitmap is indexed by the low word of the code; as in the JAX
    package, a word index past the bitmap reads its last word (JAX's
    gather clamps), which only happens when k exceeds the bitmap's k."""
    _, lo, valid = pack_kmers(codes, lens, k=k)
    lo = lo[:, ::stride]
    valid = valid[:, ::stride]
    word = torch.where(valid, lo >> 5, 0).clamp(max=bitmap.shape[0] - 1)
    got = bitmap[word]
    found = (((got >> (lo & 31)) & 1) == 1) & valid
    return found.sum(dim=1, dtype=torch.int32)


def seed_hit_counts(table_hi: torch.Tensor, table_lo: torch.Tensor,
                    codes: torch.Tensor, lens: torch.Tensor, *, k: int):
    """Per-row count of read k-mers present in the sorted seed table
    (`build_seed_table` as int64 tensors), by binary search.
    codes: (B, L) int8 -> (B,) int32 hit counts."""
    hi, lo, valid = pack_kmers(codes, lens, k=k)
    found, _ = lookup_codes(table_hi, table_lo, hi.reshape(-1),
                            lo.reshape(-1))
    found = found.reshape(hi.shape) & valid
    return found.sum(dim=1, dtype=torch.int32)
