"""centroFlyeMono pipeline driver (cen6 / monomer-alphabet assembly).

Reference chain (scripts/centroFlyeMono.py:56-117): SD report parse ->
error_correction -> iterative_graph (k 100..400) -> map_reads ->
scaffolding -> [manual cen6 scaffold join] -> read2scaffolds ->
cover_scaffolds_w_reads -> extract_read_pseudounits -> per-pseudounit Flye
polish. Here every stage is in-repo (including monomer decomposition,
mono/string_decomposer.py, replacing the external StringDecomposer) and the
polish is the deterministic consensus polisher. The reference's hard-coded
join of scaffolds 0+1 for cen6 (:84-87) is exposed as `join_scaffolds`.

The port's counterpart of the JAX package's `mono/pipeline.py`: the same
stages and files. Its device work is the decomposition (kernel K4 on
the card, `mono/string_decomposer.py`; its CLI shards it over every local
card when there are more than one); the assembly
stages are host numpy, and the polish runs on the port's
`stages/consensus.polish_consensus` (its native library).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from centroflye_tpu_torch.config import MonoConfig
from centroflye_tpu_torch.mono.sd_parser import SDReport, get_stats
from centroflye_tpu_torch.mono.error_correction import error_correction
from centroflye_tpu_torch.mono.scaffolding import (
    iterative_graph, scaffolding, read2scaffolds, cover_scaffolds_w_reads,
    extract_read_pseudounits, polish_scaffolds,
)


@dataclasses.dataclass
class MonoAssembly:
    scaffolds_mono: List[np.ndarray]      # monomer-symbol scaffolds
    scaffolds_nucl: List[str]             # polished nucleotide scaffolds
    contigs_per_k: Dict[int, List[np.ndarray]]


class MonoPipeline:
    def __init__(self, config: MonoConfig | None = None,
                 outdir: Optional[str] = None, device="cuda"):
        """device: where `decompose` runs the monomer decomposer; "cuda"
        raises without a card. `run` is host work (and the native
        library's)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MonoPipeline: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        self.config = config or MonoConfig()
        self.outdir = outdir
        if outdir:
            os.makedirs(outdir, exist_ok=True)

    def decompose(self, monomers: Dict[str, str], reads,
                  mesh=None) -> SDReport:
        """The in-repo monomer decomposer on this pipeline's device:
        (r_id, seq) reads -> SDReport, the input of `run`. mesh: None,
        "auto" or a `parallel/mesh.Mesh` over which the decomposer's steps
        shard (`MonomerDecomposer`)."""
        from centroflye_tpu_torch.mono.string_decomposer import (
            decompose_to_monostrings)
        return decompose_to_monostrings(monomers, reads,
                                        max_gap=self.config.max_gap,
                                        device=self.device, mesh=mesh)

    def run(self, sd_report: SDReport, reads: Dict[str, str],
            join_scaffolds: Optional[Sequence[int]] = None,
            verbose: bool = False) -> MonoAssembly:
        cfg = self.config
        ec = error_correction(
            dict(sd_report.monostrings), verbose=verbose,
            max_lowercase=cfg.max_lowercase, trim_max_gap=cfg.trim_max_gap,
            trim_ma_window=cfg.trim_ma_window, cut_max_gap=cfg.cut_max_gap,
            cut_min_length=cfg.cut_min_length, hor_k=cfg.hor_k,
            hor_min_mult=cfg.hor_min_mult, hor_max_gap=cfg.hor_max_gap)

        graph_dir = os.path.join(self.outdir, "idb") if self.outdir \
            else None
        contigs_per_k, dbs = iterative_graph(
            ec, min_k=cfg.min_k, max_k=cfg.max_k, min_mult=cfg.min_mult,
            max_uniq_cov=cfg.max_uniq_cov, min_uniq_len=cfg.min_uniq_len,
            verbose=verbose, outdir=graph_dir)
        db = dbs[cfg.max_k]

        mappings = db.map_reads(ec)
        scaffolds, edge_scaffolds = scaffolding(
            db, mappings, min_connections=cfg.min_connections,
            outdir=graph_dir)

        if join_scaffolds and len(scaffolds) >= 2:
            # reference cen6 manual join (centroFlyeMono.py:84-87)
            a, b = join_scaffolds[0], join_scaffolds[1]
            joined = np.concatenate(
                [scaffolds[a], scaffolds[b][db.k - 1:]])
            scaffolds = [joined]
            edge_scaffolds = [edge_scaffolds[a] + edge_scaffolds[b]]
        elif cfg.auto_join and len(scaffolds) >= 2:
            from centroflye_tpu_torch.mono.scaffolding import (
                merge_scaffolds_with_paths)
            scaffolds, edge_scaffolds = merge_scaffolds_with_paths(
                db, scaffolds, edge_scaffolds,
                min_overlap=cfg.join_min_overlap)

        r2s = read2scaffolds(db, edge_scaffolds, mappings, ec)
        coverage = cover_scaffolds_w_reads(r2s, mappings, scaffolds, ec,
                                           k=db.k)
        pseudounits, read_pseudounits = extract_read_pseudounits(
            coverage, scaffolds, ec)
        polished = polish_scaffolds(scaffolds, pseudounits,
                                    read_pseudounits, reads,
                                    n_iter=cfg.polish_n_iter)
        if self.outdir:
            from centroflye_tpu_torch.io.fasta import write_seqs
            for i, seq in enumerate(polished):
                write_seqs(os.path.join(
                    self.outdir, "polishing", f"scaffold_{i}",
                    f"scaffold_{i}.fasta"),
                    {f"scaffold_{i}_niter_{cfg.polish_n_iter}": seq})
        return MonoAssembly(scaffolds_mono=scaffolds,
                            scaffolds_nucl=polished,
                            contigs_per_k=contigs_per_k)


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="centroflye_tpu_torch mono (cen6) assembly pipeline")
    parser.add_argument("--sd-report", help="StringDecomposer TSV "
                        "(omit to run the in-repo monomer decomposer)")
    parser.add_argument("--monomers", required=True)
    parser.add_argument("--centromeric-reads", required=True)
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--min-k", type=int, default=100)
    parser.add_argument("--max-k", type=int, default=400)
    parser.add_argument("--min-mult", type=int, default=5)
    parser.add_argument("--polish-n-iter", type=int, default=2)
    parser.add_argument("--join-scaffolds", type=int, nargs=2,
                        help="join these two scaffold indices "
                        "(the reference hard-codes 0 1 for cen6)")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the monomer decomposer "
                        "(default cuda)")
    args = parser.parse_args(argv)

    from centroflye_tpu_torch.io.fasta import read_seqs

    cfg = MonoConfig(min_k=args.min_k, max_k=args.max_k,
                     min_mult=args.min_mult,
                     polish_n_iter=args.polish_n_iter)
    pipe = MonoPipeline(cfg, outdir=args.outdir, device=args.device)
    reads = read_seqs(args.centromeric_reads)
    if args.sd_report:
        sd = SDReport.from_file(args.sd_report, args.monomers)
    else:
        # every local card when there are more than one (auto_mesh)
        sd = pipe.decompose(read_seqs(args.monomers), reads.items(),
                            mesh="auto")
    asm = pipe.run(sd, reads, join_scaffolds=args.join_scaffolds,
                   verbose=True)
    for i, s in enumerate(asm.scaffolds_nucl):
        print(f"scaffold_{i}: {len(s)} bp "
              f"({len(asm.scaffolds_mono[i])} monomers)")


if __name__ == "__main__":
    main()
