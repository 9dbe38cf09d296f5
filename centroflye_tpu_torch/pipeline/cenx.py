"""cenX master pipeline on the port: the end-to-end centroFlye assembly
driver, the JAX package's `pipeline/cenx.py` in PyTorch.

The reference master driver (reference centroFlye.py:137-284) subprocess-
chains six stages communicating only through files. Here, as in the JAX
package, the chain is one in-process pipeline (`CenXPipeline.run`) with
per-stage artifacts (same filenames where the reference defines them)
and skip-if-exists resume:

  1. recruitment   -> centromeric_reads.fasta
  2. decomposition -> decomposition.json (NCRF-report role)
  3. rare + unique -> recruited_unique_kmers/unique_kmers_min_edge_cov_{c}.txt
                      + unique_edges_min_edge_cov_{c}.txt
  4. placement     -> tr_resolution/read_positions.csv
     validation    -> tr_resolution/placement_validation.csv
  5. unit consensus -> cons_unit/unit_star.fasta
  6. polishing     -> polishing/final_sequence_{k}.fasta
     tandem polish -> polishing2/polished/polished_{i}.fasta
                      -> final_assembly.fasta

Stages 1, 3, 4 and 5 run their device work on the pipeline's device
(CUDA unless the caller asks for the CPU); stages 2 and 6 are host
numpy and the port's native library. With a mesh (every local card when
there are more than one, or the `mesh` given), stages 1 and 3 shard
over it, as in the JAX package; their artifacts are the single-device
ones. `distributed=True` in a multi-process run shards stage 1's reads
over the processes, and process 0 runs the later stages. Stages 2-4 are also module
functions (`run_decomposition`, `run_unique_kmers`, `run_placement`,
`run_placement_validation`) with explicit configs, which the methods
call; each logs its phase seconds and counts in the `extra` of its log
record. `metrics.json` holds each stage's wall seconds, as the JAX
package's does.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch

from centroflye_tpu_torch.config import (CentroFlyeConfig,
                                         KmerRecruitmentConfig,
                                         PlacerConfig,
                                         UnitDecompositionConfig)
from centroflye_tpu_torch.io.encoding import kmer_strings, string_to_kmer_code
from centroflye_tpu_torch.io.fasta import (atomic_write, iter_seqs, read_seq,
                                           write_seqs)
from centroflye_tpu_torch.parallel.distributed import is_coordinator
from centroflye_tpu_torch.parallel.mesh import (auto_mesh, make_mesh,
                                                resolve_mesh)
from centroflye_tpu_torch.stages.cloud_contig import (CloudContig,
                                                      map_reads_fast)
from centroflye_tpu_torch.stages.distance_graph import (DistanceEdges,
                                                        recruit_unique_kmers)
from centroflye_tpu_torch.stages.kmer_cloud import (ReadClouds,
                                                    build_read_clouds,
                                                    filter_read_clouds,
                                                    pad_clouds)
from centroflye_tpu_torch.stages.consensus_unit import reconstruct_unit
from centroflye_tpu_torch.stages.final_polish import run_final_polish
from centroflye_tpu_torch.stages.ncrf_compat import parse_ncrf_report
from centroflye_tpu_torch.stages.polisher import EltrPolisher
from centroflye_tpu_torch.stages.rare_kmers import get_rare_kmers
from centroflye_tpu_torch.stages.read_placer import (ReadPlacer,
                                                     read_positions_file)
from centroflye_tpu_torch.stages.recruitment import recruit_file
from centroflye_tpu_torch.stages.unit_decomposition import (DecompRecord,
                                                            Decomposition,
                                                            UnitDecomposer)
from centroflye_tpu_torch.utils.logging_utils import MetricsRegistry, span

logger = logging.getLogger("centroflye_tpu_torch")


class CenXPipeline:
    def __init__(self, unit: str, config: CentroFlyeConfig, outdir: str,
                 ncrf_report: Optional[str] = None, device="cuda",
                 mesh="auto", distributed: bool = False):
        """ncrf_report: optional pinned NCRF report file — when given, the
        decomposition stage parses it (stages/ncrf_compat) instead of
        running the in-repo decomposer (bit-for-bit parity configs).
        device: where the device stages run; "cuda" raises without a
        card. mesh: "auto" shards stages 1 and 3 over the first
        `config.parallel.n_devices` local cards (0: all) on axis
        `config.parallel.data_axis` when there are more than one, and
        over none on the CPU; None forces one device; a
        `parallel/mesh.Mesh` of `device`'s type pins the devices. A mesh
        of one device is none. distributed: in a multi-process run
        (`parallel/distributed.init_distributed`), stage 1 shards the
        read stream over the processes with a merge on process 0, and the
        later stages run there (run() returns "" elsewhere).
        `config.threads`, `config.mono` and `config.polisher.error_mode`
        are not read on the cenX path, as in the JAX package."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CenXPipeline: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        if isinstance(mesh, str) and mesh == "auto":
            mesh = None
            if self.device.type == "cuda" and auto_mesh() is not None:
                mesh = make_mesh(config.parallel.n_devices,
                                 axis=config.parallel.data_axis)
        self.mesh = resolve_mesh(mesh, self.device)
        self.distributed = distributed
        self.unit = unit
        self.config = config
        self.outdir = outdir
        self.ncrf_report = ncrf_report
        os.makedirs(outdir, exist_ok=True)
        self.metrics = MetricsRegistry(outdir)

    # ----------------------------------------------------------------- #
    def _artifact(self, *parts) -> str:
        return os.path.join(self.outdir, *parts)

    def run_recruitment(self, reads_fn: str) -> str:
        """Stage 1: select centromeric reads (rr equivalent)."""
        out_fn = self._artifact("centromeric_reads.fasta")
        if os.path.exists(out_fn):
            return out_fn
        with self.metrics.stage("recruitment", "reads") as m:
            m.items = recruit_file(
                self._write_unit(), reads_fn, out_fn,
                threshold=self.config.recruitment.threshold,
                batch_size=self.config.recruitment.batch_size,
                device=self.device, mesh=self.mesh,
                distributed=self.distributed)
        return out_fn

    def _write_unit(self) -> str:
        unit_fn = self._artifact("unit.fasta")
        if not os.path.exists(unit_fn):
            write_seqs(unit_fn, {"unit": self.unit})
        return unit_fn

    def run_decomposition(self, centromeric_fn: str) -> Decomposition:
        """Stage 2: tandem decomposition (NCRF-report role). With a pinned
        NCRF report, parse it instead (parity path)."""
        return run_decomposition(self.unit, centromeric_fn,
                                 self.config.decomposition, self.outdir,
                                 self.ncrf_report, metrics=self.metrics)

    def run_unique_kmers(self, dec: Decomposition) -> np.ndarray:
        """Stages 3a+3b: rare k-mers then distance-graph unique k-mers."""
        return run_unique_kmers(dec, self.config.kmer_recruitment,
                                self.config.coverage, self.outdir,
                                self.device, metrics=self.metrics,
                                mesh=self.mesh).codes

    def run_placement(self, dec: Decomposition, uniq_codes: np.ndarray):
        """Stage 4: greedy read placement. Returns (placements, clouds)."""
        # the master driver forwards ONE k to both the k-mer recruitment
        # and the placer (reference centroFlye.py:40-44 -> :196,:213)
        return run_placement(dec, uniq_codes, self.config.placer,
                             self.config.kmer_recruitment.k, self.outdir,
                             self.device, metrics=self.metrics)

    def run_placement_validation(self, placements, clouds) -> Set[str]:
        """Post-placement validation: the ids of the reads whose re-map
        agrees with their placement (see run_placement_validation)."""
        return run_placement_validation(
            placements, clouds, self.config.placer,
            self.config.kmer_recruitment, self.outdir)

    def run_unit_consensus(self, dec: Decomposition) -> str:
        """Stage 5: consensus unit (unit*) reconstruction, its k-mer count
        on the pipeline's device."""
        out_fn = self._artifact("cons_unit", "unit_star.fasta")
        if os.path.exists(out_fn):
            return read_seq(out_fn)
        seqs = [rec.seq for rec in dec.records.values()]
        unit_star = reconstruct_unit(seqs, self.unit,
                                     self.config.consensus_unit,
                                     device=self.device)
        write_seqs(out_fn, {"unit*": unit_star})
        return unit_star

    def run_polisher(self, dec: Decomposition, placements) -> str:
        """Stage 6a: per-position consensus polishing (eltr role)."""
        n = self.config.polisher.num_iters
        eltr_fn = self._artifact("polishing",
                                 f"final_sequence_{n}.fasta")
        if os.path.exists(eltr_fn):
            return read_seq(eltr_fn)
        unit_instances = {r_id: rec.motif_alignments()
                          for r_id, rec in dec.records.items()}
        polisher = EltrPolisher(self.config.polisher)
        with self.metrics.stage("polishing", "positions") as m:
            out = polisher.run(placements, unit_instances,
                               outdir=self._artifact("polishing"))
            m.items = len(out.final_sequences.get(n, ""))
        return out.final_sequences.get(n, "")

    def run_tandem_polish(self, dec: Decomposition, placements,
                          assembly: str) -> str:
        """Stage 6b: assembly-level re-polish from raw read spans (the
        reference's tandemQUAST --only-polish role, centroFlye.py:252-272)
        -> final_assembly.fasta."""
        final_fn = self._artifact("final_assembly.fasta")
        if os.path.exists(final_fn):
            return read_seq(final_fn)
        with self.metrics.stage("tandem_polish", "bases") as m:
            final = run_final_polish(
                assembly, placements, dec.records,
                self._artifact("polishing2"),
                n_iters=self.config.polisher.num_iters)
            m.items = len(final)
        write_seqs(final_fn, {"centroFlye_assembly": final})
        return final

    # ----------------------------------------------------------------- #
    def run(self, reads_fn: str) -> str:
        """Full chain; returns the final assembly sequence (on process 0
        of a distributed run; "" on the others, which take part in stage
        1 only)."""
        centromeric_fn = self.run_recruitment(reads_fn)
        if self.distributed and not is_coordinator():
            return ""
        dec = self.run_decomposition(centromeric_fn)
        uniq = self.run_unique_kmers(dec)
        placements, clouds = self.run_placement(dec, uniq)
        agree = self.run_placement_validation(placements, clouds)
        # polish only with validation-agreeing placements: a read placed
        # off by a few units votes the wrong base at every intra-array
        # mutation site (see run_placement_validation)
        n_placed = sum(1 for p in placements.values() if p is not None)
        if agree and len(agree) >= 0.8 * max(n_placed, 1):
            placements_p = {r: (p if p is None or r in agree else None)
                            for r, p in placements.items()}
        else:
            # collapsed/low-agreement runs keep every placement — a thin
            # validated subset would polish from near-zero coverage
            placements_p = placements
        self.run_unit_consensus(dec)
        assembly = self.run_polisher(dec, placements_p)
        return self.run_tandem_polish(dec, placements_p, assembly)


def run_decomposition(unit: str, centromeric_fn: str,
                      config: UnitDecompositionConfig, outdir: str,
                      ncrf_report: Optional[str] = None, *,
                      metrics: Optional[MetricsRegistry] = None
                      ) -> Decomposition:
    """Stage 2: tandem decomposition (NCRF-report role) of the reads in
    `centromeric_fn`, on the host. With a pinned NCRF report, parse it
    instead (parity path). Writes `outdir/decomposition.json`; an existing
    one is read back instead (resume). The decomposer's run is stage
    "decomposition" of `metrics`, as in the JAX package."""
    cache_fn = os.path.join(outdir, "decomposition.json")
    if os.path.exists(cache_fn):
        return load_decomposition(cache_fn)
    t0 = time.perf_counter()
    if ncrf_report:
        dec = parse_ncrf_report(ncrf_report,
                                min_record_len=config.min_record_len)
    else:
        with (metrics or MetricsRegistry()).stage("decomposition",
                                                  "reads") as m:
            dec = UnitDecomposer(unit, config).decompose(
                iter_seqs(centromeric_fn))
            m.items = len(dec.records)
    t1 = time.perf_counter()
    save_decomposition(dec, cache_fn)
    t2 = time.perf_counter()
    logger.info("decomposition %.3fs (%d records), artifact %.3fs",
                t1 - t0, len(dec.records), t2 - t1)
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
                     coverage: int, outdir: str, device="cuda", *,
                     metrics: Optional[MetricsRegistry] = None,
                     mesh=None) -> UniqueKmers:
    """Stages 3a+3b: rare k-mers then distance-graph unique k-mers, on
    `device`, or sharded over `mesh` (a `parallel/mesh.Mesh`). Writes the two artifacts under
    `outdir/recruited_unique_kmers/` as the JAX pipeline does and returns
    the result (`.codes` is what the JAX pipeline returns); an existing
    k-mer artifact is read back instead (resume). The computation is
    stage "unique_kmers" of `metrics`."""
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
    with (metrics or MetricsRegistry()).stage("unique_kmers", "kmers") as m:
        t0 = time.perf_counter()
        with span("rare"):
            rare = get_rare_kmers(seqs, config, coverage, device=device,
                                  mesh=mesh)
        t1 = time.perf_counter()
        with span("clouds"):
            clouds = build_read_clouds(records, rare, config.k)
            _, tensor, n_units, _ = pad_clouds(clouds, sorted(records))
        t2 = time.perf_counter()
        with span("sweep"):
            # a (i, j, d) key repeats once per read spanning both unit copies
            # with BOTH k-mers surviving that read's errors: ~coverage/2
            # spanning reads x survival^2 joint retention — the strip-count
            # divisor that keeps per-strip tables near capacity without
            # overflowing them
            surv = float(config.kmer_survival_rate)
            uniq_codes, edges = recruit_unique_kmers(
                tensor, n_units, rare, config, device=device, mesh=mesh,
                dedup_hint=max(1, int(int(coverage) / 2 * surv * surv)))
        t3 = time.perf_counter()
        m.items = len(uniq_codes)

    # artifact parity: sorted kmer strings, one per line (reference
    # distance_based_kmer_recruitment.py:158-171)
    with span("artifacts"):
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
        len(edges.i))
    return UniqueKmers(uniq_codes, rare, tensor, n_units, edges)


def run_placement(dec: Decomposition, uniq_codes: np.ndarray,
                  config: PlacerConfig, k: int, outdir: str, device="cuda",
                  *, metrics: Optional[MetricsRegistry] = None
                  ) -> Tuple[Dict[str, Optional[int]], Dict[str, ReadClouds]]:
    """Stage 4: greedy read placement, its bulk scoring on `device`.
    `k` is the unique k-mers' length: the master driver forwards ONE k to
    both the k-mer recruitment and the placer (reference
    centroFlye.py:40-44 -> :196,:213). Writes
    `outdir/tr_resolution/read_positions.csv`; an existing one is read
    back instead (resume). Returns (placements, the filtered clouds).
    The placer's run is stage "placement" of `metrics`."""
    pos_fn = os.path.join(outdir, "tr_resolution", "read_positions.csv")
    records = {r: dec.records[r] for r in sorted(dec.records)}
    t0 = time.perf_counter()
    with span("placement_clouds"):
        clouds = build_read_clouds(records, uniq_codes, k)
        clouds = filter_read_clouds(clouds, min_mult=config.min_kmer_mult)
    t1 = time.perf_counter()
    if os.path.exists(pos_fn):
        return read_positions_file(pos_fn), clouds
    placer = ReadPlacer(config, device=device)
    with (metrics or MetricsRegistry()).stage("placement", "reads") as m:
        placements = placer.run(dec, clouds)
        placed = sum(1 for p in placements.values() if p is not None)
        m.items = placed
    t2 = time.perf_counter()
    with span("placement_artifact"):
        placer.write_positions(pos_fn)
    t3 = time.perf_counter()
    logger.info("placement: clouds %.3fs, placement %.3fs, artifact %.3fs "
                "(%d of %d reads placed)", t1 - t0, t2 - t1, t3 - t2,
                placed, len(placements))
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
    with span("validation"):
        contig = CloudContig(config.min_cloud_kmer_freq)
        for r_id, pos in placements.items():
            if pos is not None and r_id in clouds:
                contig.add_read(clouds[r_id], pos)
        positions, _ = map_reads_fast(
            contig, clouds, threshold=(config.min_unit, config.min_inters))
    t1 = time.perf_counter()
    with span("validation_artifact"):
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
                "(%.3fs, artifact %.3fs)", n_same, placed, t1 - t0, t2 - t1)
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


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="centroflye_tpu_torch cenX assembly pipeline")
    parser.add_argument("-i", "--reads", required=True,
                        help="reads FASTA/FASTQ(.gz)")
    parser.add_argument("-o", "--outdir", required=True)
    parser.add_argument("-u", "--unit", required=True,
                        help="HOR unit FASTA (DXZ1_rc for cenX)")
    parser.add_argument("-c", "--coverage", type=int, required=True)
    parser.add_argument("--ncrf", help="pinned NCRF report (parity path: "
                        "parse it instead of running the decomposer)")
    parser.add_argument("--config", help="JSON config file overriding "
                        "defaults (CentroFlyeConfig.to_json format)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the device stages "
                        "(default cuda)")
    args = parser.parse_args(argv)

    if args.config:
        with open(args.config) as f:
            config = CentroFlyeConfig.from_json(f.read())
        config = config.replace(coverage=args.coverage)
    else:
        config = CentroFlyeConfig(coverage=args.coverage)
    unit = read_seq(args.unit)
    pipeline = CenXPipeline(unit, config, args.outdir,
                            ncrf_report=args.ncrf, device=args.device)
    final = pipeline.run(args.reads)
    print(f"final assembly length: {len(final)}")


if __name__ == "__main__":
    main()
