"""Time cen6's monomer de Bruijn sweep (`mono/scaffolding.iterative_graph`,
host numpy and Python) of the port, or of the JAX package, on the
monomer-space world of benchmarks/bench_mono_cen6.py's part B: 800 D6Z1
HORs with a variant monomer at one position in 24, reads of its
ultra-long mix with 2% gap symbols, error-corrected with `MonoConfig()`.
Prints one JSON line: the package, reads, monomers, rounds, the seconds
of error correction and of the sweep, and the scaffolds of the last
round's graph; with --profile, cProfile's top functions first.

    python3 tools/probe_mono_graph.py [--package port|jax] [--coverage 30]
        [--min-k 100] [--max-k 400] [--profile]

Host work only: no card needed. The two packages' sweeps write the same
files (tests/test_torch_mono.py), so timing both on one machine in one
call compares their host code.
"""

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

N_MONO = 18


def world(coverage, seed=23, n_hor=800, gap_rate=0.02):
    """bench_mono_cen6.build_symbol_genome and simulate_monoreads: (array
    symbols, [(r_id, symbols)])."""
    rng = np.random.default_rng(seed)
    syms = np.tile(np.arange(N_MONO, dtype=np.int16), n_hor)
    for pos in rng.choice(len(syms), len(syms) // 24, replace=False):
        cur = int(syms[pos])
        alt = [x for x in range(N_MONO) if x != cur]
        syms[pos] = alt[int(rng.integers(0, N_MONO - 1))]
    L = len(syms)
    n = int(coverage * L / 430.0)
    ul = rng.random(n) < 0.3
    lens = np.clip(np.where(ul, rng.lognormal(np.log(700), 0.5, n),
                            rng.lognormal(np.log(280), 0.55, n)),
                   30, 2000).astype(np.int64)
    starts = rng.integers(-50, L - 20, size=n)
    reads = []
    for i in range(n):
        s = max(0, int(starts[i]))
        e = min(L, s + int(lens[i]))
        if e - s < 30:
            continue
        r = syms[s:e].astype(np.int16)
        reads.append((f"m{i:06d}",
                      np.where(rng.random(len(r)) < gap_rate, -1, r)
                      .astype(np.int16)))
    return syms, reads


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--package", choices=("port", "jax"), default="port")
    parser.add_argument("--coverage", type=int, default=30)
    parser.add_argument("--min-k", type=int, default=100)
    parser.add_argument("--max-k", type=int, default=400)
    parser.add_argument("--profile", action="store_true")
    args = parser.parse_args(argv)
    if args.package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from centroflye_tpu.config import MonoConfig
        from centroflye_tpu.mono.error_correction import error_correction
        from centroflye_tpu.mono.monostring import MonoString
        from centroflye_tpu.mono.scaffolding import (iterative_graph,
                                                     scaffolding)
    else:
        from centroflye_tpu_torch.config import MonoConfig
        from centroflye_tpu_torch.mono.error_correction import (
            error_correction)
        from centroflye_tpu_torch.mono.monostring import MonoString
        from centroflye_tpu_torch.mono.scaffolding import (iterative_graph,
                                                           scaffolding)
    _, reads = world(args.coverage)
    monoreads = {r: MonoString(r, s, np.full((len(s), 2), -1, np.int32),
                               N_MONO) for r, s in reads}
    cfg = MonoConfig()
    t = time.perf_counter()
    ec = error_correction(
        monoreads, max_lowercase=cfg.max_lowercase,
        trim_max_gap=cfg.trim_max_gap, trim_ma_window=cfg.trim_ma_window,
        cut_max_gap=cfg.cut_max_gap, cut_min_length=cfg.cut_min_length,
        hor_k=cfg.hor_k, hor_min_mult=cfg.hor_min_mult,
        hor_max_gap=cfg.hor_max_gap)
    ec_s = time.perf_counter() - t
    prof = cProfile.Profile() if args.profile else None
    t = time.perf_counter()
    if prof:
        prof.enable()
    _, dbs = iterative_graph(ec, min_k=args.min_k, max_k=args.max_k,
                             min_mult=cfg.min_mult,
                             max_uniq_cov=cfg.max_uniq_cov,
                             min_uniq_len=cfg.min_uniq_len)
    if prof:
        prof.disable()
    graph_s = time.perf_counter() - t
    if prof:
        pstats.Stats(prof).sort_stats("cumulative").print_stats(15)
    db = dbs[args.max_k]
    scaffolds, _ = scaffolding(db, db.map_reads(ec), cfg.min_connections)
    print(json.dumps({
        "package": args.package, "reads": len(reads),
        "monomers": int(sum(len(s) for _, s in reads)),
        "rounds": args.max_k - args.min_k + 1,
        "error_correction_seconds": ec_s, "iterative_graph_seconds": graph_s,
        "scaffolds": [len(s) for s in scaffolds]}), flush=True)


if __name__ == "__main__":
    main()
