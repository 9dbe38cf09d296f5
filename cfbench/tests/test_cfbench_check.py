"""The check that decides `correct`, on tiny cells through the port's CPU
path: the reference agrees with the program, the control (the reference
that breaks a stated guarantee, in the program's place) comes out not
correct, and so does a run with the timed path broken underneath, once
for each fault the cell can have."""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from cfbench import run as R
from cfbench.tests.conftest import tiny_decompose_cell, tiny_recruit_cell

SEED = 2 ** 31 + 99


def cpu_mesh():
    from centroflye_tpu_torch.parallel.mesh import Mesh
    return Mesh([torch.device("cpu")] * 4)


def test_recruit_correct_and_control(unit_file):
    res = R.run(tiny_recruit_cell(unit_file), SEED, 0, False, device="cpu",
                control=True)
    assert res["correct"], res
    assert res["failed"] == 0 and res["attempted"] == 1
    assert list(res)[-1] == "checks"
    assert res["control"]["decisions_wrong"]["value"] > 0


def test_decompose_correct_and_control():
    res = R.run(tiny_decompose_cell(), SEED, 0, False, device="cpu",
                control=True)
    assert res["correct"], res
    assert res["control"]["reads_wrong"]["value"] > 0


@contextlib.contextmanager
def patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    try:
        yield
    finally:
        setattr(obj, name, old)


def half_left_out(orig):
    """Half of the reads never scored: each odd read comes out as no
    match."""
    def run(self, reads):
        for i, res in enumerate(orig(self, reads)):
            if i % 2:
                res.recruited = False
            yield res
    return run


def answer_altered(orig):
    """The distances of each launch's first row altered where the kernel
    produces them."""
    def recruit_distances(*a, **k):
        df, dr = orig(*a, **k)
        df, dr = df.clone(), dr.clone()
        df[:1] += 1000
        dr[:1] += 1000
        return df, dr
    return recruit_distances


def exchange_left_out(orig):
    """Only the first card's shard comes back: the others' rows arrive
    as no match."""
    def make(*a, **kw):
        fused = orig(*a, **kw)
        raw = fused.raw

        def raw_first_only(packed, n_mask, lens):
            out = raw(packed, n_mask, lens).clone()
            n_dev = fused.n_dev
            blocks = out.view(n_dev, -1)
            Bs = lens.shape[0] // n_dev
            blocks[1:, :2 * Bs] = kw["m"]
            blocks[1:, 2 * Bs:3 * Bs] = 0
            return out
        fused.raw = raw_first_only
        return fused
    return make


def state_unchanged(orig):
    """The sequence-parallel tier's chunk step returns its state
    unchanged."""
    def myers_carry(peq, text, lens, state, *a, **k):
        return state
    return myers_carry


def small_seqpar(orig):
    """Reads of 1,024 bases or more take the sequence-parallel tier."""
    def config(*a, **k):
        k.setdefault("seq_parallel_min_len", 1024)
        return orig(*a, **k)
    return config


def recruit_faults():
    import centroflye_tpu_torch.ops.fused_recruit as fr
    import centroflye_tpu_torch.parallel.seq_parallel as sp
    import centroflye_tpu_torch.stages.recruitment as rec
    return {
        "half_left_out": (False, [(rec.RecruitmentEngine, "run",
                                   half_left_out)]),
        "answer_altered": (False, [(fr, "recruit_distances",
                                    answer_altered)]),
        "exchange_left_out": (True, [(fr, "make_fused_recruit",
                                      exchange_left_out)]),
        "state_unchanged": (True, [(rec, "RecruitmentConfig", small_seqpar),
                                   (sp, "myers_carry", state_unchanged)]),
    }


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered",
                                   "exchange_left_out", "state_unchanged"])
def test_recruit_fault_is_caught(unit_file, fault):
    four, patches = recruit_faults()[fault]
    cell = tiny_recruit_cell(unit_file)
    if four:        # candidate rows on every card's shard
        cell.traffic["stream"]["tandem"]["share"] = 0.6
    if fault == "state_unchanged":
        cell.traffic["stream"]["lengths"] = {"mix": [[1, 1200, 0.3]],
                                             "clip": [600, 2000]}
        cell.traffic["stream"]["reads"] = 60
    with contextlib.ExitStack() as stack:
        for obj, name, make in patches:
            stack.enter_context(patched(obj, name, make))
        res = R.run(cell, SEED, 0, False, device="cpu",
                    mesh=cpu_mesh() if four else None)
    assert not res["correct"], res
    assert res["failed"] >= 1


def test_recruit_four_card_path_correct(unit_file):
    """The recruitment cell's path on a CPU mesh of four (the port's
    default on a host of four cards), with the sequence-parallel tier on,
    agrees with the reference."""
    import centroflye_tpu_torch.stages.recruitment as rec
    cell = tiny_recruit_cell(unit_file, reads=40)
    cell.traffic["stream"]["lengths"] = {"mix": [[1, 1100, 0.2]],
                                         "clip": [600, 1500]}
    cell.traffic["stream"]["tandem"]["share"] = 0.6
    with patched(rec, "RecruitmentConfig", small_seqpar):
        res = R.run(cell, SEED, 0, False, device="cpu", mesh=cpu_mesh())
    assert res["correct"], res


def decompose_half_left_out(orig):
    def batch(self, chunk):
        out = orig(self, chunk)
        return {r: recs for i, (r, recs) in enumerate(out.items())
                if i % 2 == 0}
    return batch


def decompose_answer_altered(orig):
    """Each step's first call moved to another monomer where the device
    step produces it."""
    def step(self, windows, lens):
        q, d, e = orig(self, windows, lens)
        q = q.copy()
        q[:1] = (q[:1] + 1) % (2 * self.n)
        return q, d, e
    return step


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered"])
def test_decompose_fault_is_caught(fault):
    from centroflye_tpu_torch.mono.string_decomposer import MonomerDecomposer
    name, make = {"half_left_out": ("_decompose_batch",
                                    decompose_half_left_out),
                  "answer_altered": ("_step", decompose_answer_altered)}[
                      fault]
    cell = tiny_decompose_cell()
    cell.params["check_reads"] = 50
    with patched(MonomerDecomposer, name, make):
        res = R.run(cell, SEED, 0, False, device="cpu")
    assert not res["correct"], res


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["cenx.recruit.rel2",
                                  "cen6.decompose.rel3"])
def test_cell_on_the_card(cuda, cell):
    """One short run of each one-card cell on the card, with the control:
    correct, and the control not."""
    from cfbench.lib import spec
    res = R.run(spec.load_cell(cell), SEED, 1, False, control=True)
    assert res["correct"], res
    assert any(v["value"] > v["limit"] for v in res["control"].values())
    assert np.isfinite(list(res["metrics"].values())[0]["value"])
