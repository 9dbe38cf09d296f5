"""Seedable read simulation (host numpy): the generators the port's tests
and `chip_smoke.py` need. Given the same `np.random.Generator` state they
return the same output as the JAX package's `pipeline/simulate.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

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
