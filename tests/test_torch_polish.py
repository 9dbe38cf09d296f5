"""Stage 6 of cenX on the port (`stages/polisher`, `stages/final_polish`)
against the JAX package, on a numpy-seeded tandem array: per-position
polishing and the final polish write the same files byte for byte, and
their helpers return the same values. Both native libraries are built
first and asserted loaded."""

import dataclasses
import os

import numpy as np
import pytest

from centroflye_tpu import native as jnative
from centroflye_tpu.config import PolisherConfig as JPolisherConfig
from centroflye_tpu.pipeline.simulate import (add_read_noise, gen_random_seq,
                                              simulate_tandem_repeat)
from centroflye_tpu.stages import final_polish as jfinal
from centroflye_tpu.stages import polisher as jpol

from centroflye_tpu_torch import native as tnative
from centroflye_tpu_torch.config import PolisherConfig
from centroflye_tpu_torch.ops.align_path import align_path
from centroflye_tpu_torch.stages import final_polish as tfinal
from centroflye_tpu_torch.stages import polisher as tpol

UNIT = 150
MULT = 24


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert jnative.load_native(build=True) is not None, \
        "the JAX package's libcfnative.so did not build"
    assert tnative.load_library() is not None


@dataclasses.dataclass
class Record:
    """What the polish stages read of a decomposition record."""

    seq: str
    n_units: int


@pytest.fixture(scope="module")
def world():
    """A 24-unit array at 3% divergence; 64 reads of 3-9 whole units at 4%
    noise, each with its placement (its first unit), among them reads
    at both ends of the array and two unplaced reads."""
    rng = np.random.default_rng(31)
    unit = gen_random_seq(rng, UNIT)
    sim = simulate_tandem_repeat(rng, unit, mult=MULT, div_rate=0.03,
                                 flank_len=0)
    copies = [sim.tr[i * UNIT:(i + 1) * UNIT] for i in range(MULT)]
    placements, instances, records = {}, {}, {}
    starts = [0, 0, MULT - 6, MULT - 4] + \
        rng.integers(0, MULT - 3, 60).tolist()
    for i, p in enumerate(starts):
        n = int(min(rng.integers(3, 10), MULT - p))
        inst = [add_read_noise(rng, copies[j], 0.04) for j in range(p, p + n)]
        r_id = f"r{i:02d}"
        placements[r_id] = int(p)
        instances[r_id] = inst
        records[r_id] = Record("".join(inst), n)
    for r_id in ("u0", "u1"):
        placements[r_id] = None
        instances[r_id] = [add_read_noise(rng, copies[0], 0.04)] * 3
        records[r_id] = Record("".join(instances[r_id]), 3)
    return dict(sim=sim, placements=placements, instances=instances,
                records=records)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            fn = os.path.join(d, name)
            with open(fn, "rb") as f:
                out[os.path.relpath(fn, root)] = f.read()
    return out


@pytest.mark.parametrize("min_pos,max_pos", [(0, float("inf")), (2, 15)])
def test_map_pos2read_equal(world, min_pos, max_pos):
    got = tpol.map_pos2read(world["placements"], world["instances"],
                            min_pos=min_pos, max_pos=max_pos)
    assert got == jpol.map_pos2read(world["placements"], world["instances"],
                                    min_pos=min_pos, max_pos=max_pos)
    # reads at the contig's ends vote with their end units too
    if min_pos == 0:
        assert ("r00", 0) in got[0]
        assert ("r03", 3) in got[MULT - 1]
    assert tpol.median_high([3, 1, 2, 5]) == jpol.median_high([3, 1, 2, 5])


@pytest.mark.parametrize("num_iters", [1, 3])
def test_eltr_polisher_files_equal(world, tmp_path, num_iters):
    got = tpol.EltrPolisher(PolisherConfig(num_iters=num_iters)).run(
        world["placements"], world["instances"],
        outdir=str(tmp_path / "port"))
    want = jpol.EltrPolisher(JPolisherConfig(num_iters=num_iters)).run(
        world["placements"], world["instances"],
        outdir=str(tmp_path / "jax"))
    assert got.final_sequences == want.final_sequences
    assert got.comparison == want.comparison
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert {f"final_sequence_{i}.fasta" for i in range(1, num_iters + 1)} \
        | {f"final_sequence_hpc_{i}.fasta" for i in range(1, num_iters + 1)} \
        | {"report.txt"} == set(files)
    # the polished array is close to the truth
    seq = got.final_sequences[num_iters]
    assert align_path(seq, world["sim"].tr, mode="NW").dist \
        < 0.01 * len(world["sim"].tr)


def test_eltr_polisher_nothing_placed():
    empty = {"a": None}
    got = tpol.EltrPolisher().run(empty, {"a": ["ACGT"]})
    assert got.final_sequences == {} and got.comparison == []


def test_edit_distance_grows_k(monkeypatch):
    """Distances above the first threshold (1024) take one 4x growth of
    k; both packages give the exact NW distance."""
    rng = np.random.default_rng(32)
    a = gen_random_seq(rng, 3000)
    b = add_read_noise(rng, a, 0.6)
    ks = []
    real = tpol.native_edit_distance

    def record(q, t, mode, k):
        ks.append(k)
        return real(q, t, mode=mode, k=k)
    monkeypatch.setattr(tpol, "native_edit_distance", record)
    d = tpol._edit_distance(a, b)
    assert ks == [1024, 4096]
    assert d == jpol._edit_distance(a, b) > 1024
    assert d == align_path(a, b, mode="NW", prefer_native=False).dist
    for x, y in (("", "ACG"), ("ACGT", ""), ("ACGT", "AGT"), (b, a)):
        assert tpol._edit_distance(x, y) == jpol._edit_distance(x, y)


def test_spans_from_placements_equal(world):
    got = tfinal.spans_from_placements(world["placements"], world["records"])
    assert got == jfinal.spans_from_placements(world["placements"],
                                               world["records"])
    assert all(isinstance(x, float) for _, fs, fe in got for x in (fs, fe))
    assert tfinal.spans_from_placements({"a": None}, {}) == []
    assert tfinal.spans_from_placements(
        world["placements"], world["records"], total_len_units=40) == \
        jfinal.spans_from_placements(world["placements"], world["records"],
                                     total_len_units=40)


def _corrupted_assembly(world, seed=33, n_errors=30):
    rng = np.random.default_rng(seed)
    s = list(world["sim"].tr)
    for p in sorted(rng.choice(len(s) - 1, n_errors, replace=False))[::-1]:
        r = rng.random()
        if r < 0.4:
            s[p] = "ACGT"[("ACGT".index(s[p]) + 1) % 4]
        elif r < 0.7:
            del s[p]
        else:
            s.insert(p, "ACGT"[int(rng.integers(0, 4))])
    return "".join(s)


@pytest.mark.parametrize("window", [300, 512])
def test_polish_assembly_with_reads_equal(world, window):
    """Two iterations: windows at phase 0, then at half a window."""
    asm = _corrupted_assembly(world)
    spans = tfinal.spans_from_placements(world["placements"],
                                         world["records"])
    got = tfinal.polish_assembly_with_reads(asm, spans, n_iters=2,
                                            window=window)
    assert got == jfinal.polish_assembly_with_reads(asm, spans, n_iters=2,
                                                    window=window)
    truth = world["sim"].tr
    assert align_path(got[2], truth, mode="NW").dist < \
        align_path(asm, truth, mode="NW").dist


def test_anchor_segments_equal(world):
    rng = np.random.default_rng(34)
    tr = world["sim"].tr
    tasks = []
    for w in range(12):
        a = int(rng.integers(0, len(tr) - 400))
        template = tr[a:a + 300]
        target = add_read_noise(rng, tr[max(0, a - 100):a + 400], 0.05)
        exp = None if w % 3 == 0 else int(rng.integers(60, 140))
        tasks.append((w, template, target, 0, exp))
    tasks.append((12, tr[:300], gen_random_seq(rng, 200), 0, None))
    for max_slip in (None, 20):
        got = tfinal._anchor_segments_batched(tasks, 0.35, max_slip=max_slip)
        assert got == jfinal._anchor_segments_batched(tasks, 0.35,
                                                      max_slip=max_slip)
    for _, template, target, _, _ in tasks:
        assert tfinal._anchor_segment(template, target, 20, 380, 0.35) == \
            jfinal._anchor_segment(template, target, 20, 380, 0.35)


def test_negative_pair_distance_takes_the_per_pair_path(world, monkeypatch):
    """One negative distance in the native pairs batch sends every task
    through the per-pair host path, in both packages."""
    rng = np.random.default_rng(35)
    tr = world["sim"].tr
    tasks = [(w, tr[a:a + 250], add_read_noise(rng, tr[a - 50:a + 300],
                                               0.05), 0, 50)
             for w, a in enumerate(range(100, 2500, 300))]

    def stub(real):
        def pairs(queries, targets, mode="HW", threads=0):
            res = real(queries, targets, mode=mode, threads=threads)
            return [(-1, "", 0, 0)] + res[1:]
        return pairs
    want = tfinal._anchor_segments_batched(tasks, 0.35, max_slip=40)
    monkeypatch.setattr(tfinal, "native_align_path_pairs",
                        stub(tnative.native_align_path_pairs))
    monkeypatch.setattr(jnative, "native_align_path_pairs",
                        stub(jnative.native_align_path_pairs))
    got = tfinal._anchor_segments_batched(tasks, 0.35, max_slip=40)
    assert got == jfinal._anchor_segments_batched(tasks, 0.35, max_slip=40)
    assert got == want and len(got) == len(tasks)


@pytest.mark.parametrize("n_iters", [1, 2])
def test_run_final_polish_files_equal(world, tmp_path, n_iters):
    asm = _corrupted_assembly(world, seed=36)
    got = tfinal.run_final_polish(asm, world["placements"], world["records"],
                                  str(tmp_path / "port"), n_iters=n_iters)
    want = jfinal.run_final_polish(asm, world["placements"],
                                   world["records"], str(tmp_path / "jax"),
                                   n_iters=n_iters)
    assert got == want
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert {f"polished/polished_{i}.fasta" for i in range(1, n_iters + 1)} \
        | {"report.txt"} == set(files)
