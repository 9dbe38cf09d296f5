"""Tiny cells for the CPU tests: the cells of BENCHMARK.json with their
sizes cut so that the port's plain CPU path runs them in seconds (a
90-base unit at threshold 15, reads of hundreds of bases; a six-HOR
monomer array). Tests that need the card take the `cuda` fixture."""

from __future__ import annotations

import copy
import os

import numpy as np
import pytest

from cfbench.lib import spec


@pytest.fixture(scope="session")
def unit_file(tmp_path_factory):
    rng = np.random.default_rng(3)
    unit = "".join("ACGT"[i] for i in rng.integers(0, 4, 90))
    fn = os.path.join(tmp_path_factory.mktemp("data"), "unit.fasta")
    with open(fn, "w") as f:
        f.write(f">unit\n{unit}\n")
    return fn


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def tiny_recruit_cell(unit_file: str, reads: int = 160) -> spec.Cell:
    cell = spec.load_cell("cenx.recruit.rel2")
    cell.config = copy.deepcopy(cell.config)
    cell.config["run"].update(unit=unit_file, threshold=15, seg_len=1024)
    cell.traffic = {"sizes_seed": 0, "stream": {
        "reads": reads, "lengths": {"mix": [[1, 500, 0.5]],
                                    "clip": [100, 2500]},
        "tandem": {"unit": unit_file, "share": 0.1, "noise": 0.05}}}
    cell.params = dict(cell.params, warmup_reads=16, check_background=24)
    return cell


def tiny_decompose_cell() -> spec.Cell:
    cell = spec.load_cell("cen6.decompose.rel3")
    cell.config = copy.deepcopy(cell.config)
    cell.config["run"]["batch_reads"] = 6
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["array"].update(
        hors=6, coverage=2, mean_monomers=12.0,
        lengths={"mix": [[1, 34, 0.1]], "clip": [30, 40]})
    cell.params = dict(cell.params, warmup_reads=2, check_reads=4)
    return cell
