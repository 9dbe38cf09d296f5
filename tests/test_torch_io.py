"""The port's `io` package and data files against the JAX package's:
`min_cyclic_shift` equal (and the brute-force least rotation), the same
16 exported names, each the port's own object; and the unit and monomer
FASTA files the port reads are its own copies, byte for byte the JAX
package's."""

import os

import numpy as np
import pytest

import centroflye_tpu.io as jio
from centroflye_tpu.io import encoding as jenc

import centroflye_tpu_torch
import centroflye_tpu_torch.io as tio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _strings():
    rng = np.random.default_rng(12)
    out = ["", "A", "AA", "BA", "ABAB", "CABAB", "ACGTACGA", "TTTTA",
           "GATTACA" * 3]
    for n in (2, 3, 7, 30, 171):
        for alphabet in ("AC", "ACGT"):
            out.append("".join(rng.choice(list(alphabet), n)))
    return out


@pytest.mark.parametrize("s", _strings())
def test_min_cyclic_shift_equal(s):
    got = tio.min_cyclic_shift(s)
    assert got == jenc.min_cyclic_shift(s)
    assert got == min((s[i:] + s[:i] for i in range(len(s))), default="")


def test_io_exports_the_jax_names():
    names = {n for n in vars(jio) if not n.startswith("_")}
    names -= {"encoding", "fasta"}
    assert len(names) == 16
    assert {n for n in vars(tio) if not n.startswith("_")} - \
        {"encoding", "fasta"} == names
    for n in names:
        obj = getattr(tio, n)
        if callable(obj):
            assert obj.__module__.startswith("centroflye_tpu_torch."), n
        else:
            assert obj == getattr(jio, n), n


@pytest.mark.parametrize("name", ["DXZ1_rc.fasta", "D6Z1.fasta",
                                  "D6Z1_monomers.fasta"])
def test_data_files_are_the_jax_packages(name):
    mine = os.path.join(centroflye_tpu_torch.DATA_DIR, name)
    assert os.path.dirname(mine) == os.path.join(
        REPO, "centroflye_tpu_torch", "data")
    with open(mine, "rb") as a, \
            open(os.path.join(REPO, "centroflye_tpu", "data", name),
                 "rb") as b:
        assert a.read() == b.read()
