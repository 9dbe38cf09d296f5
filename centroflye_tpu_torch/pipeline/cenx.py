"""Stage 3 of the cenX pipeline on the port: rare k-mers, then the
distance-graph unique k-mers, from a saved decomposition.

The JAX package's `pipeline/cenx.py` drives all six stages as methods of
`CenXPipeline`. Until the port has that class, this module holds the
decomposition file format (`save_decomposition`, `load_decomposition`,
copies of the JAX package's) and stage 3 as a function,
`run_unique_kmers`, with the body of `CenXPipeline.run_unique_kmers`:

  3. rare + unique -> recruited_unique_kmers/unique_kmers_min_edge_cov_{c}.txt
                      + unique_edges_min_edge_cov_{c}.txt
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional

import numpy as np

from centroflye_tpu_torch.config import KmerRecruitmentConfig
from centroflye_tpu_torch.io.encoding import kmer_strings, string_to_kmer_code
from centroflye_tpu_torch.io.fasta import atomic_write
from centroflye_tpu_torch.stages.distance_graph import (DistanceEdges,
                                                        recruit_unique_kmers)
from centroflye_tpu_torch.stages.kmer_cloud import (build_read_clouds,
                                                    pad_clouds)
from centroflye_tpu_torch.stages.rare_kmers import get_rare_kmers
from centroflye_tpu_torch.stages.unit_decomposition import (DecompRecord,
                                                            Decomposition)

logger = logging.getLogger("centroflye_tpu_torch")


@dataclasses.dataclass
class UniqueKmers:
    """What stage 3 found. `codes` always; the rest only when it ran, not
    when it resumed from its k-mer artifact."""

    codes: np.ndarray                     # sorted uint64 unique k-mers
    rare: Optional[np.ndarray] = None     # sorted uint64 rare k-mers
    # the sweep's input: (R, T, K) rare-k-mer indices per record and unit
    # instance, -1 padded, and each record's unit count
    clouds: Optional[np.ndarray] = None
    n_units: Optional[np.ndarray] = None
    edges: Optional[DistanceEdges] = None


def run_unique_kmers(dec: Decomposition, config: KmerRecruitmentConfig,
                     coverage: int, outdir: str,
                     device="cuda") -> UniqueKmers:
    """Stages 3a+3b: rare k-mers then distance-graph unique k-mers, on
    `device`. Writes the two artifacts under
    `outdir/recruited_unique_kmers/` as the JAX pipeline does and returns
    the result (`.codes` is what the JAX pipeline returns); an existing
    k-mer artifact is read back instead (resume)."""
    outdir = os.path.join(outdir, "recruited_unique_kmers")
    kmers_fn = os.path.join(
        outdir, f"unique_kmers_min_edge_cov_{config.min_coverage}.txt")
    if os.path.exists(kmers_fn):
        with open(kmers_fn) as f:
            return UniqueKmers(np.sort(np.array(
                [string_to_kmer_code(line.strip()) for line in f
                 if line.strip()], dtype=np.uint64)))
    os.makedirs(outdir, exist_ok=True)

    records = {r: dec.records[r] for r in sorted(dec.records)}
    seqs = [rec.seq for rec in records.values()]
    t0 = time.perf_counter()
    rare = get_rare_kmers(seqs, config, coverage, device=device)
    t1 = time.perf_counter()
    clouds = build_read_clouds(records, rare, config.k)
    _, tensor, n_units, _ = pad_clouds(clouds, sorted(records))
    t2 = time.perf_counter()
    # a (i, j, d) key repeats once per read spanning both unit copies
    # with BOTH k-mers surviving that read's errors: ~coverage/2 spanning
    # reads x survival^2 joint retention — the strip-count divisor that
    # keeps per-strip tables near capacity without overflowing them
    surv = float(config.kmer_survival_rate)
    uniq_codes, edges = recruit_unique_kmers(
        tensor, n_units, rare, config, device=device,
        dedup_hint=max(1, int(int(coverage) / 2 * surv * surv)))
    t3 = time.perf_counter()

    # artifact parity: sorted kmer strings, one per line (reference
    # distance_based_kmer_recruitment.py:158-171)
    strs = kmer_strings(uniq_codes, config.k)
    with atomic_write(kmers_fn) as f:
        for s in sorted(strs):
            print(s, file=f)
    edges_fn = os.path.join(
        outdir, f"unique_edges_min_edge_cov_{config.min_coverage}.txt")
    rare_strs = np.asarray(kmer_strings(rare, config.k))
    # vectorized formatting: edge files reach millions of rows at
    # production scale, a per-row print() loop costs minutes there
    with atomic_write(edges_fn) as f:
        for e0 in range(0, len(edges.i), 1 << 20):
            sl = slice(e0, e0 + (1 << 20))
            cols = np.char.add(np.char.add(np.char.add(np.char.add(
                np.char.add(np.char.add(
                    edges.dist[sl].astype(str), " "),
                    rare_strs[edges.i[sl]]), " "),
                rare_strs[edges.j[sl]]), " "),
                edges.freq[sl].astype(str))
            f.write("\n".join(cols.tolist()))
            if len(cols):
                f.write("\n")
    t4 = time.perf_counter()
    logger.info(
        "unique_kmers phases: rare %.3fs (%d kmers), clouds %.3fs, "
        "sweep+filter %.3fs, artifacts %.3fs (%d unique, %d edges)",
        t1 - t0, len(rare), t2 - t1, t3 - t2, t4 - t3, len(uniq_codes),
        len(edges.i), extra={
            "seconds": {"rare": t1 - t0, "clouds": t2 - t1,
                        "sweep": t3 - t2, "artifacts": t4 - t3},
            "counts": {"rare_kmers": len(rare),
                       "unique_kmers": len(uniq_codes),
                       "edges": len(edges.i)}})
    return UniqueKmers(uniq_codes, rare, tensor, n_units, edges)


# ------------------------- decomposition (de)serialization ----------------


def save_decomposition(dec: Decomposition, filename: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    payload = {
        "records": {
            r_id: {
                "r_len": rec.r_len, "strand": rec.strand,
                "r_st": rec.r_st, "r_en": rec.r_en, "seq": rec.seq,
                "bounds": rec.bounds.tolist(),
            } for r_id, rec in dec.records.items()
        },
        "positions_all": {
            r_id: [[st, en, strand] for st, en, strand in ivs]
            for r_id, ivs in dec.positions_all.items()
        },
        "read_lens": dec.read_lens,
        "discarded": dec.discarded,
    }
    with atomic_write(filename) as f:
        json.dump(payload, f)


def load_decomposition(filename: str) -> Decomposition:
    with open(filename) as f:
        payload = json.load(f)
    records = {
        r_id: DecompRecord(
            r_id=r_id, r_len=d["r_len"], strand=d["strand"],
            r_st=d["r_st"], r_en=d["r_en"], seq=d["seq"],
            bounds=np.array(d["bounds"], dtype=np.int32))
        for r_id, d in payload["records"].items()
    }
    positions_all = {
        r_id: [(st, en, strand) for st, en, strand in ivs]
        for r_id, ivs in payload["positions_all"].items()
    }
    return Decomposition(records=records, positions_all=positions_all,
                         read_lens=payload["read_lens"],
                         discarded=payload["discarded"])
