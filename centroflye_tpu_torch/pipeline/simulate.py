"""Seedable read simulation (host numpy): the generators the recruitment
tests and `chip_smoke.py` need. Given the same `np.random.Generator`
state they return the same output as the JAX package's
`pipeline/simulate.py`.
"""

from __future__ import annotations

import numpy as np

BASES = "ACGT"


def gen_random_seq(rng: np.random.Generator, length: int) -> str:
    return "".join(BASES[i] for i in rng.integers(0, 4, size=length))


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
