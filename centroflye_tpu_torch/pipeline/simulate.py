"""Synthetic tandem repeats and noisy long reads (seedable, host numpy),
a copy of the JAX package's `pipeline/simulate.py`: given the same
`np.random.Generator` state every function returns the same output, and
the CLI writes the same files.

    python -m centroflye_tpu_torch.pipeline.simulate --multiplicity 30 \
        --div-rate 0.01 -o out/ --seed 1 --n-reads 50
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

BASES = "ACGT"


def gen_random_seq(rng: np.random.Generator, length: int) -> str:
    return "".join(BASES[i] for i in rng.integers(0, 4, size=length))


@dataclasses.dataclass
class TandemRepeatSim:
    unit: str
    tr: str                       # the pure tandem repeat
    left_flanked_tr: str          # left flank + tr
    flanked_tr: str               # left flank + tr + right flank
    all_muts: Dict[int, List]     # unit copy index -> [(pos, new_base)]
    flank_len: int


def simulate_tandem_repeat(
    rng: np.random.Generator,
    unit: str,
    mult: int,
    div_rate: float,
    flank_len: int = 200000,
) -> TandemRepeatSim:
    """Mutate `mult` copies of `unit` at an average `div_rate` per base and
    flank with random sequence (reference simulate_tandem_repeat.py:15-34:
    binomial total mutation count, copies drawn uniformly, distinct positions
    per copy, substitutions only)."""
    n_mut = int(rng.binomial(n=len(unit) * mult, p=div_rate))
    copy_of_mut = rng.integers(0, mult, size=n_mut)
    units = [unit] * mult
    all_muts: Dict[int, List] = {}
    for copy_idx in sorted(set(copy_of_mut.tolist())):
        n = int((copy_of_mut == copy_idx).sum())
        n = min(n, len(unit))
        positions = rng.choice(len(unit), size=n, replace=False)
        new_unit = list(unit)
        muts = []
        for pos in positions:
            pos = int(pos)
            choices = [b for b in BASES if b != new_unit[pos]]
            new_unit[pos] = choices[int(rng.integers(0, 3))]
            muts.append((pos, new_unit[pos]))
        units[copy_idx] = "".join(new_unit)
        all_muts[copy_idx] = muts
    tr = "".join(units)
    left = gen_random_seq(rng, flank_len)
    right = gen_random_seq(rng, flank_len)
    return TandemRepeatSim(
        unit=unit, tr=tr, left_flanked_tr=left + tr,
        flanked_tr=left + tr + right, all_muts=all_muts,
        flank_len=flank_len)


def add_read_noise(rng: np.random.Generator, seq: str,
                   error_rate: float) -> str:
    """Apply uniform substitution/insertion/deletion noise (each 1/3 of
    error_rate), the standard long-read error model."""
    if error_rate <= 0:
        return seq
    out = []
    third = error_rate / 3
    rs = rng.random(len(seq))
    for i, ch in enumerate(seq):
        r = rs[i]
        if r < third:
            continue                                   # deletion
        if r < 2 * third:
            out.append(BASES[int(rng.integers(0, 4))])  # insertion (before)
            out.append(ch)
            continue
        if r < error_rate:
            choices = [b for b in BASES if b != ch]
            out.append(choices[int(rng.integers(0, 3))])  # substitution
            continue
        out.append(ch)
    return "".join(out)


def add_read_noise_clustered(rng: np.random.Generator, seq: str,
                             nominal_rate: float) -> str:
    """Clustered, homopolymer-biased ONT-like noise at `nominal_rate`
    errors per base. Real nanopore error is NOT uniform: errors arrive in
    bursts and concentrate on homopolymer runs (deletion-dominant), so a
    nominal 8-10% read error destroys far fewer k=19-mers than uniform
    errors of the same rate — the regime the reference's default
    kmer-survival-rate 0.34 encodes (reference centroFlye.py:52:
    (1-e)^19 = 0.34 at e ~ 5.5% EFFECTIVE).

    Model: error CLUSTERS start at per-base rate nominal_rate / mean_len
    with start probability doubled inside homopolymer runs (length >= 3,
    renormalized so the average error mass stays at nominal_rate); a
    cluster spans 1 + Geometric(1/2) bases (mean 2); each clustered base
    is deleted with prob 0.5 (homopolymer-dominant ONT behavior),
    substituted with 0.3, or gets an insertion with 0.2. The
    uniform-equivalent error of the model is measured, not assumed:
    clustered_effective_error() calibrates k-mer survival empirically."""
    if nominal_rate <= 0:
        return seq
    n = len(seq)
    if n == 0:
        return seq
    mean_len = 2.0
    arr = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    # homopolymer-run membership (runs of length >= 3)
    same = arr[1:] == arr[:-1]
    run_id = np.concatenate([[0], np.cumsum(~same)])
    run_len = np.bincount(run_id)
    in_hp = run_len[run_id] >= 3
    w = np.where(in_hp, 2.0, 1.0)
    lam = nominal_rate / mean_len
    starts = rng.random(n) < lam * w * (n / max(w.sum(), 1.0))
    out = []
    i = 0
    start_idx = np.flatnonzero(starts)
    si = 0
    while i < n:
        if si < len(start_idx) and i == start_idx[si]:
            clen = max(1, min(int(rng.geometric(0.5)), n - i))  # mean 2
            for j in range(i, i + clen):
                r = rng.random()
                if r < 0.5:
                    continue                          # deletion
                if r < 0.8:
                    choices = [b for b in BASES if b != seq[j]]
                    out.append(choices[int(rng.integers(0, 3))])
                else:
                    out.append(BASES[int(rng.integers(0, 4))])
                    out.append(seq[j])                # insertion (before)
            i += clen
            while si < len(start_idx) and start_idx[si] < i:
                si += 1
        else:
            out.append(seq[i])
            i += 1
            if si < len(start_idx) and start_idx[si] < i:
                si += 1
    return "".join(out)


_EFF_CACHE: Dict = {}


def clustered_effective_error(nominal_rate: float, k: int = 19) -> float:
    """The uniform-equivalent per-base error of the clustered model at
    `nominal_rate`, MEASURED (not derived): simulate a long random
    sequence, apply clustered noise, measure the k-mer survival s =
    |kmers(clean) ∩ kmers(noisy)| / |kmers(clean)| (random sequence ⇒
    k-mers are essentially unique), and solve (1-e)^k = s. Deterministic
    (fixed internal seed) and cached."""
    key = (round(float(nominal_rate), 6), k)
    if key not in _EFF_CACHE:
        rng = np.random.default_rng(123457)
        clean = gen_random_seq(rng, 300_000)
        noisy = add_read_noise_clustered(rng, clean, nominal_rate)
        kms = {clean[i:i + k] for i in range(len(clean) - k + 1)}
        kmn = {noisy[i:i + k] for i in range(len(noisy) - k + 1)}
        s = len(kms & kmn) / max(len(kms), 1)
        _EFF_CACHE[key] = 1.0 - s ** (1.0 / k)
    return _EFF_CACHE[key]


@dataclasses.dataclass
class SimulatedRead:
    r_id: str
    seq: str
    start: int        # true start in the genome (forward coords)
    end: int          # true end (exclusive)
    strand: str       # '+' or '-'


def simulate_reads(
    rng: np.random.Generator,
    genome: str,
    n_reads: int,
    read_len_mean: int,
    read_len_std: int,
    error_rate: float,
    min_len: int = 500,
    both_strands: bool = True,
) -> List[SimulatedRead]:
    """Sample noisy reads uniformly from `genome`. Deterministic given rng."""
    from centroflye_tpu_torch.io.encoding import revcomp_str

    reads = []
    for i in range(n_reads):
        rlen = max(min_len, int(rng.normal(read_len_mean, read_len_std)))
        rlen = min(rlen, len(genome))
        start = int(rng.integers(0, len(genome) - rlen + 1))
        raw = genome[start:start + rlen]
        strand = "-" if (both_strands and rng.random() < 0.5) else "+"
        if strand == "-":
            raw = revcomp_str(raw)
        noisy = add_read_noise(rng, raw, error_rate)
        reads.append(SimulatedRead(
            r_id=f"sim_read_{i:05d}_{strand}",
            seq=noisy, start=start, end=start + rlen, strand=strand))
    return reads


def simulate_tiling_reads(
    rng: np.random.Generator,
    genome: str,
    read_len: int,
    stride: int,
    error_rate: float,
    both_strands: bool = True,
) -> List[SimulatedRead]:
    """Deterministically tile the genome with overlapping noisy reads —
    guarantees coverage of every position (useful for assembly tests where
    uniform sampling might leave gaps)."""
    from centroflye_tpu_torch.io.encoding import revcomp_str

    reads = []
    i = 0
    for start in range(0, max(1, len(genome) - read_len + 1), stride):
        raw = genome[start:start + read_len]
        strand = "-" if (both_strands and rng.random() < 0.5) else "+"
        oriented = revcomp_str(raw) if strand == "-" else raw
        noisy = add_read_noise(rng, oriented, error_rate)
        reads.append(SimulatedRead(
            r_id=f"tile_read_{i:05d}_{strand}",
            seq=noisy, start=start, end=start + len(raw), strand=strand))
        i += 1
    return reads


def write_simulation(sim: TandemRepeatSim, output_dir: str) -> None:
    """Write the reference-compatible artifact set
    (reference simulate_tandem_repeat.py:37-55)."""
    from centroflye_tpu_torch.io import write_seqs

    os.makedirs(output_dir, exist_ok=True)
    write_seqs(os.path.join(output_dir, "tandem_repeat.fasta"),
               {"sim_tr": sim.tr})
    write_seqs(os.path.join(output_dir, "left_flanked_tandem_repeat.fasta"),
               {"left_flanked_sim_tr": sim.left_flanked_tr})
    write_seqs(os.path.join(output_dir, "flanked_tandem_repeat.fasta"),
               {"flanked_sim_tr": sim.flanked_tr})
    with open(os.path.join(output_dir, "all_muts.json"), "w") as f:
        muts = {str(k): [[int(p), b] for p, b in v]
                for k, v in sim.all_muts.items()}
        json.dump(muts, f)
    with open(os.path.join(output_dir, "simulation.log"), "w") as f:
        total = sum(len(v) for v in sim.all_muts.values())
        print(f"full_tr_len = {len(sim.tr)}", file=f)
        print(f"total_n_mut = {total}", file=f)
        for pos, muts_ in sim.all_muts.items():
            print(f"{pos} : {len(muts_)}", file=f)


def parse_sim_read_id(r_id: str) -> Optional[Dict[str, object]]:
    """Parse this simulator's read ids ("sim_read_<idx>_<strand>" /
    "tile_read_<idx>_<strand>") into metadata — the role of the reference's
    scripts/read.py SimLoRD-metadata parser for our own simulator."""
    parts = r_id.split("_")
    if len(parts) != 4 or parts[1] != "read":
        return None
    try:
        return {"kind": parts[0], "index": int(parts[2]),
                "strand": parts[3]}
    except ValueError:
        return None


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Simulate a tandem repeat (+ optionally noisy reads)")
    parser.add_argument("--unit", help="unit FASTA; default random")
    parser.add_argument("--unit-len", type=int, default=200)
    parser.add_argument("--multiplicity", type=int, required=True)
    parser.add_argument("--div-rate", type=float, required=True)
    parser.add_argument("--flank-len", type=int, default=200000)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--seed", type=int)
    parser.add_argument("--n-reads", type=int, default=0,
                        help="also simulate this many noisy reads")
    parser.add_argument("--read-len-mean", type=int, default=50000)
    parser.add_argument("--read-len-std", type=int, default=15000)
    parser.add_argument("--error-rate", type=float, default=0.1)
    args = parser.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    if args.unit:
        from centroflye_tpu_torch.io import read_seq
        unit = read_seq(args.unit)
    else:
        unit = gen_random_seq(rng, args.unit_len)
    sim = simulate_tandem_repeat(rng, unit, args.multiplicity, args.div_rate,
                                 flank_len=args.flank_len)
    write_simulation(sim, args.output)
    if args.n_reads:
        from centroflye_tpu_torch.io import write_seqs
        reads = simulate_reads(rng, sim.flanked_tr, args.n_reads,
                               args.read_len_mean, args.read_len_std,
                               args.error_rate)
        write_seqs(os.path.join(args.output, "reads.fasta"),
                   {r.r_id: r.seq for r in reads})


if __name__ == "__main__":
    main()
