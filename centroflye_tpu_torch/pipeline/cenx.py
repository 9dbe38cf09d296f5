"""Stages 2-4 of the cenX pipeline on the port: unit decomposition, rare
k-mers then the distance-graph unique k-mers, greedy placement then its
validation.

The JAX package's `pipeline/cenx.py` drives all six stages as methods of
`CenXPipeline`. Until the port has that class, this module holds the
decomposition file format (`save_decomposition`, `load_decomposition`,
copies of the JAX package's) and each ported stage as a function with
the body of the method of the same name, writing the same artifacts
under `outdir`, and reading an existing one back instead (resume):

  2. decomposition -> decomposition.json (NCRF-report role)
  3. rare + unique -> recruited_unique_kmers/unique_kmers_min_edge_cov_{c}.txt
                      + unique_edges_min_edge_cov_{c}.txt
  4. placement     -> tr_resolution/read_positions.csv
     validation    -> tr_resolution/placement_validation.csv

Each logs its phase seconds and counts in the `extra` of its log record.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, Optional, Set, Tuple

import numpy as np

from centroflye_tpu_torch.config import (KmerRecruitmentConfig,
                                         PlacerConfig,
                                         UnitDecompositionConfig)
from centroflye_tpu_torch.io.encoding import kmer_strings, string_to_kmer_code
from centroflye_tpu_torch.io.fasta import atomic_write, iter_seqs
from centroflye_tpu_torch.stages.cloud_contig import (CloudContig,
                                                      map_reads_fast)
from centroflye_tpu_torch.stages.distance_graph import (DistanceEdges,
                                                        recruit_unique_kmers)
from centroflye_tpu_torch.stages.kmer_cloud import (ReadClouds,
                                                    build_read_clouds,
                                                    filter_read_clouds,
                                                    pad_clouds)
from centroflye_tpu_torch.stages.ncrf_compat import parse_ncrf_report
from centroflye_tpu_torch.stages.rare_kmers import get_rare_kmers
from centroflye_tpu_torch.stages.read_placer import (ReadPlacer,
                                                     read_positions_file)
from centroflye_tpu_torch.stages.unit_decomposition import (DecompRecord,
                                                            Decomposition,
                                                            UnitDecomposer)

logger = logging.getLogger("centroflye_tpu_torch")


def run_decomposition(unit: str, centromeric_fn: str,
                      config: UnitDecompositionConfig, outdir: str,
                      ncrf_report: Optional[str] = None) -> Decomposition:
    """Stage 2: tandem decomposition (NCRF-report role) of the reads in
    `centromeric_fn`, on the host. With a pinned NCRF report, parse it
    instead (parity path). Writes `outdir/decomposition.json`; an existing
    one is read back instead (resume)."""
    cache_fn = os.path.join(outdir, "decomposition.json")
    if os.path.exists(cache_fn):
        return load_decomposition(cache_fn)
    t0 = time.perf_counter()
    if ncrf_report:
        dec = parse_ncrf_report(ncrf_report,
                                min_record_len=config.min_record_len)
    else:
        dec = UnitDecomposer(unit, config).decompose(iter_seqs(centromeric_fn))
    t1 = time.perf_counter()
    save_decomposition(dec, cache_fn)
    t2 = time.perf_counter()
    logger.info("decomposition %.3fs (%d records), artifact %.3fs",
                t1 - t0, len(dec.records), t2 - t1, extra={
                    "seconds": {"decomposition": t1 - t0,
                                "decomposition_artifact": t2 - t1},
                    "counts": {"records": len(dec.records)}})
    return dec


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


def run_placement(dec: Decomposition, uniq_codes: np.ndarray,
                  config: PlacerConfig, k: int, outdir: str, device="cuda"
                  ) -> Tuple[Dict[str, Optional[int]], Dict[str, ReadClouds]]:
    """Stage 4: greedy read placement, its bulk scoring on `device`.
    `k` is the unique k-mers' length: the master driver forwards ONE k to
    both the k-mer recruitment and the placer (reference
    centroFlye.py:40-44 -> :196,:213). Writes
    `outdir/tr_resolution/read_positions.csv`; an existing one is read
    back instead (resume). Returns (placements, the filtered clouds)."""
    pos_fn = os.path.join(outdir, "tr_resolution", "read_positions.csv")
    records = {r: dec.records[r] for r in sorted(dec.records)}
    t0 = time.perf_counter()
    clouds = build_read_clouds(records, uniq_codes, k)
    clouds = filter_read_clouds(clouds, min_mult=config.min_kmer_mult)
    t1 = time.perf_counter()
    if os.path.exists(pos_fn):
        return read_positions_file(pos_fn), clouds
    placer = ReadPlacer(config, device=device)
    placements = placer.run(dec, clouds)
    t2 = time.perf_counter()
    placer.write_positions(pos_fn)
    t3 = time.perf_counter()
    placed = sum(1 for p in placements.values() if p is not None)
    logger.info("placement: clouds %.3fs, placement %.3fs, artifact %.3fs "
                "(%d of %d reads placed)", t1 - t0, t2 - t1, t3 - t2,
                placed, len(placements), extra={
                    "seconds": {"placement_clouds": t1 - t0,
                                "placement": t2 - t1,
                                "placement_artifact": t3 - t2},
                    "counts": {"placed": placed}})
    return placements, clouds


def run_placement_validation(placements: Dict[str, Optional[int]],
                             clouds: Dict[str, ReadClouds],
                             config: PlacerConfig,
                             kmer_config: KmerRecruitmentConfig,
                             outdir: str) -> Set[str]:
    """Post-placement validation (the reference's map_reads_fast debug
    idea, cloud_contig.py:117-156, as a persisted artifact): rebuild the
    contig from the placements and re-map every read, on the host; writes
    tr_resolution/placement_validation.csv with re-mapped positions.
    Returns the set of read ids whose re-map AGREES with their
    placement — the polish stages consume only those (a read placed
    off by a few units aligns fine against the 99.7%-identical
    template but votes the WRONG base at every intra-array mutation
    site). `kmer_config` is stage 3's, named by the collapse warning."""
    out_fn = os.path.join(outdir, "tr_resolution",
                          "placement_validation.csv")
    if os.path.exists(out_fn):
        agree = set()
        with open(out_fn) as f:
            next(f)
            for line in f:
                parts = line.split()
                if len(parts) == 4 and parts[3] == "True" \
                        and parts[1] != "None":
                    agree.add(parts[0])
        return agree
    t0 = time.perf_counter()
    contig = CloudContig(config.min_cloud_kmer_freq)
    for r_id, pos in placements.items():
        if pos is not None and r_id in clouds:
            contig.add_read(clouds[r_id], pos)
    positions, _ = map_reads_fast(
        contig, clouds, threshold=(config.min_unit, config.min_inters))
    t1 = time.perf_counter()
    n_same = 0
    agree_set = set()
    with atomic_write(out_fn) as f:
        print("r_id placed remapped agree", file=f)
        for r_id, pos in placements.items():
            remapped = positions.get(r_id)
            agree = (pos == remapped)
            if agree and pos is not None:
                n_same += 1
                agree_set.add(r_id)
            print(r_id, pos, remapped, agree, file=f)
    t2 = time.perf_counter()
    placed = sum(1 for p in placements.values() if p is not None)
    logger.info("placement validation: %d/%d re-map to their placement "
                "(%.3fs, artifact %.3fs)", n_same, placed, t1 - t0, t2 - t1,
                extra={"seconds": {"validation": t1 - t0,
                                   "validation_artifact": t2 - t1},
                       "counts": {"agree": n_same}})
    # starvation/misplacement tripwire: a healthy run places most
    # decomposed reads and they re-map consistently; both collapse
    # when the edge-coverage cutoff starves at low coverage. Surface the
    # fix.
    total = max(len(placements), 1)
    if placed and (placed < 0.2 * total or n_same < 0.5 * placed) \
            and not kmer_config.auto_min_coverage:
        logger.warning(
            "placement collapse signature: %d/%d reads placed, %d/%d "
            "re-map. At low coverage the fixed min_coverage=%d edge "
            "cutoff starves the unique-k-mer stage (the reference "
            "pipeline behaves identically); re-run with "
            "kmer_recruitment.auto_min_coverage=True",
            placed, total, n_same, placed, kmer_config.min_coverage)
    return agree_set


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
