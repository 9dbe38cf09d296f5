"""The port's monomer decomposer (`mono/string_decomposer.py`, its CPU
path: the plain version of kernel K4) against the JAX package's, on the
same reads: equal records row for row, for exact, noisy and
reverse-strand reads of tests/test_mono_e2e.py's world, the real D6Z1
monomers on a 2-HOR read, lockstep batches of 1, 4 and 32 reads, the
port's default and a batch larger than the read set, and reads that make
gap steps (no alignment progress). Also: K4's wrapper on the CPU equals
the JAX package's `myers_distance_batch` on the decomposer's row layout
(`np.repeat` of the windows beside `np.tile` of the queries), its call
(SHW/call) that layout's rows followed by numpy's argmin(dist / ms),
also on exact quotient ties, and `convert.decomposer_state_from_numpy`
carries the JAX decomposer's tables into the port's. Tests marked `gpu`
hold K4 (both calls, also where it stages the columns in several tiles)
against its plain version and the card's decomposer against the CPU's."""

import os

import numpy as np
import pytest
import torch

from centroflye_tpu.io import read_seqs
from centroflye_tpu.io.encoding import revcomp_str
from centroflye_tpu.mono.string_decomposer import (
    MonomerDecomposer as JDecomposer,
    MonomerDecomposerConfig as JConfig,
    decompose_to_monostrings as jdecompose)
from centroflye_tpu.ops.myers import myers_distance_batch as jmyers
from centroflye_tpu.pipeline.simulate import add_read_noise

import chip_smoke as cs
from centroflye_tpu_torch.convert import decomposer_state_from_numpy
from centroflye_tpu_torch.mono.string_decomposer import (
    MonomerDecomposer as TDecomposer,
    MonomerDecomposerConfig as TConfig,
    decompose_to_monostrings as tdecompose)
from centroflye_tpu_torch.ops.myers import build_peq, words_tensor
from centroflye_tpu_torch.ops.myers_cuda import (
    PERROW_CALLS, myers_perrow, myers_perrow_plain, perrow_queries)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D6Z1 = os.path.join(REPO, "centroflye_tpu", "data", "D6Z1_monomers.fasta")
MONO_LEN = cs.MONO_FRESH_LEN


@pytest.fixture(scope="module")
def world():
    monomers, syms, genome, _ = cs.mono_fresh_world()
    rng = np.random.default_rng(3)
    reads = [("exact", genome[:20 * MONO_LEN]),
             ("noisy", add_read_noise(rng, genome[:30 * MONO_LEN], 0.05)),
             ("reverse", revcomp_str(genome[:15 * MONO_LEN])),
             ("offset", add_read_noise(rng, genome[37:900], 0.03)),
             ("short", genome[:20]), ("empty", "")]
    return monomers, syms, reads


@pytest.mark.parametrize("batch_reads", [1, 4, 32, None, 7])
def test_records_equal_jax(world, batch_reads):
    """Lockstep batches of 1, 4 and 32 reads (the JAX decomposer at the
    same batch), the port's default (4,096) and 7, one more than the
    read set (the JAX decomposer at its default of 32)."""
    monomers, syms, reads = world
    want = JDecomposer(monomers, JConfig(batch_reads=batch_reads)
                       if batch_reads in (1, 4, 32) else JConfig()
                       ).decompose(reads)
    cfg = TConfig() if batch_reads is None else TConfig(
        batch_reads=batch_reads)
    assert batch_reads is not None or cfg.batch_reads == 4096
    got = TDecomposer(monomers, cfg, device="cpu").decompose(reads)
    assert got == want
    assert list(got) == [r for r, _ in reads]
    assert [r[0] for r in got["exact"]] == syms[:20].tolist()
    assert got["empty"] == [] and got["short"] == []


def test_d6z1_monomers_on_a_2hor_read():
    """The real 18 D6Z1 monomers (~171 bp, highly similar) on a noisy
    2-HOR read and its reverse complement."""
    monomers = read_seqs(D6Z1)
    rng = np.random.default_rng(17)
    read = add_read_noise(rng, "".join(monomers.values()) * 2, 0.05)
    reads = [("f", read), ("r", revcomp_str(read))]
    want = JDecomposer(monomers, JConfig(batch_reads=2)).decompose(reads)
    got = TDecomposer(monomers, TConfig(batch_reads=2),
                      device="cpu").decompose(reads)
    assert got == want
    called = [r[0] for r in got["f"]]
    assert sum(a == b for a, b in zip(called, list(range(18)) * 2)) >= 32


def test_gap_steps(world):
    """Windows the monomers cannot align into (all N; a window too short
    to beat the empty alignment) make gap steps after the first (HW)
    step: a '-' row of one monomer's length, as in the JAX package."""
    monomers, _, reads = world
    rows = [("n", "N" * 400), ("mixed", "N" * 150 + reads[0][1][:300]),
            ("tail", reads[0][1][:MONO_LEN + 31])]
    want = JDecomposer(monomers).decompose(rows)
    got = TDecomposer(monomers, device="cpu").decompose(rows)
    assert got == want
    assert all(r[3] == "-" and r[2] - r[1] == MONO_LEN
               for r in got["n"][1:])
    assert len(got["n"]) >= 6


def test_decompose_to_monostrings_equal(world):
    monomers, _, reads = world
    j = jdecompose(monomers, reads, max_gap=80)
    t = tdecompose(monomers, reads, max_gap=80, device="cpu")
    assert list(j.monostrings) == list(t.monostrings)
    for r, m in j.monostrings.items():
        n = t.monostrings[r]
        assert (m.name, m.syms.tolist(), m.nucl.tolist(), m.n_monomers,
                m.strand) == (n.name, n.syms.tolist(), n.nucl.tolist(),
                              n.n_monomers, n.strand)
    assert t.monomer_names == j.monomer_names
    assert t.monostrings["reverse"].strand == "-"


def test_state_from_the_jax_tables(world):
    monomers, _, reads = world
    jdec = JDecomposer(monomers)
    tdec = TDecomposer(monomers, device="cpu")
    assert np.array_equal(tdec.peqs, jdec.peqs) and \
        np.array_equal(tdec.ms, jdec.ms)
    state = decomposer_state_from_numpy(jdec.peqs, jdec.ms)
    assert torch.equal(state["peqs"], tdec.queries.peqs)
    assert torch.equal(state["ms"], tdec.queries.ms)
    carried = TDecomposer(monomers, device="cpu", state=state)
    assert carried.decompose(reads[:3]) == jdec.decompose(reads[:3])
    with pytest.raises(TypeError):
        decomposer_state_from_numpy(jdec.peqs.astype(np.int64), jdec.ms)
    with pytest.raises(TypeError):
        decomposer_state_from_numpy(jdec.peqs, jdec.ms[:-1])


def jax_rows(args, mode, collect):
    """The JAX `myers_distance_batch` on K4's row layout (`np.repeat` of
    the windows beside `np.tile` of the queries), from K4's CPU
    arguments."""
    queries, windows, wlens = args
    peqs = queries.peqs.numpy().astype(np.uint32)
    ms, windows, wlens = queries.ms.numpy(), windows.numpy(), wlens.numpy()
    R, Q = len(windows), len(peqs)
    return jmyers(np.tile(peqs, (R, 1, 1)), np.repeat(windows, Q, 0),
                  np.repeat(wlens, Q), m=queries.m, mode=mode,
                  ms=np.tile(ms, R), collect=collect)


def jax_calls(args):
    """Each window's call as the JAX decomposer chooses it: SHW rows,
    then np.argmin(dist / ms) (the first on ties)."""
    queries, windows, _ = args
    rows = jax_rows(args, "SHW", "best")
    ms = queries.ms.numpy()
    dist = np.asarray(rows["dist"]).reshape(len(windows), -1)
    end = np.asarray(rows["end"]).reshape(len(windows), -1)
    q = np.argmin(dist / np.maximum(ms[None, :], 1), axis=1)
    at = np.arange(len(q))
    return {"q": q, "dist": dist[at, q], "end": end[at, q]}


@pytest.mark.parametrize("m", [1, 31, 32, 33, 64, 256])
def test_perrow_plain_equals_jax_layout(m):
    """K4's wrapper on CPU tensors (its plain version) gives the JAX
    `myers_distance_batch` on the decomposer's layout: SHW/best rows
    from the plain version, HW/all from the wrapper, and the wrapper's
    SHW/call those rows' argmin(dist / ms), on phase k4's small cases
    (`chip_smoke.k4_small`); any other call of the wrapper raises."""
    args = cs.k4_small(np.random.default_rng(m), m, "cpu")
    for mode, collect in (("SHW", "best"), ("HW", "all")):
        want = jax_rows(args, mode, collect)
        got = myers_perrow_plain(*args, mode=mode, collect=collect)
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    got = myers_perrow(*args, mode="HW", collect="all")
    assert np.array_equal(got["scores"].numpy(),
                          np.asarray(jax_rows(args, "HW", "all")["scores"]))
    got = myers_perrow(*args, mode="SHW", collect="call")
    want = jax_calls(args)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), want[k]), k
    for mode, collect in (("XX", "call"), ("HW", "call"), ("NW", "best"),
                          ("SHW", "best"), ("SHW", "all")):
        with pytest.raises(ValueError):
            myers_perrow(*args, mode=mode, collect=collect)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_perrow_call_equals_jax_argmin(seed):
    """The plain SHW/call equals the JAX decomposer's choice (SHW rows on
    the decomposer's layout, then np.argmin(dist / ms)) on windows with
    exact quotient ties (10/170 = 5/85, 2/170 = 1/85, 0/170 = 0/85),
    all-N windows and zero-length windows (`chip_smoke.k4_ties`): the
    first query on a tie."""
    args = cs.k4_ties(np.random.default_rng(seed), "cpu")
    queries, windows, wlens = args
    want = jax_calls(args)
    got = myers_perrow_plain(*args, mode="SHW", collect="call")
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k
    rows = myers_perrow_plain(*args, mode="SHW", collect="best")
    assert cs.exact_ties(rows["dist"].reshape(len(windows), -1),
                         queries.ms) >= 8
    q, d = want["q"], want["dist"]
    assert (q[:4] == 0).all() and (d[:4] == 10).all()      # 10/170 = 5/85
    assert (q[4:8] == 1).all() and (d[4:8] == 4).all()     # 4/85 < 10/170
    allN = (wlens.numpy() == 0) | (windows.numpy() == 4).all(1)
    assert allN.sum() == 4 and (q[allN] == 0).all() \
        and (d[allN] == 170).all() and (want["end"][allN] == -1).all()


def test_perrow_queries_rejects_bad_tables():
    """The query set is checked once, on the host: lengths outside
    [1, m], tables of the wrong shape or type."""
    peqs = words_tensor(np.stack([build_peq(np.zeros(n, np.int8), m=40)
                                  for n in (40, 7)]), "cpu")
    ok = perrow_queries(peqs, np.array([40, 7], np.int32), m=40,
                        device="cpu")
    assert ok.words is None and ok.ms.dtype == torch.int32
    for ms in ([41, 7], [40, 0], [40]):
        with pytest.raises(ValueError):
            perrow_queries(peqs, np.array(ms, np.int32), m=40, device="cpu")
    with pytest.raises(ValueError):
        perrow_queries(peqs.int(), np.array([40, 7], np.int32), m=40,
                       device="cpu")
    with pytest.raises(ValueError):
        perrow_queries(peqs, np.array([40, 7], np.int32), m=70,
                       device="cpu")


def test_decomposer_cuda_raises_without_cuda(world):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TDecomposer(world[0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K4 (csrc/myers_perrow.cu)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 31, 32, 33, 64, 173, 256])
def test_perrow_kernel_matches_plain_on_gpu(cuda, m):
    """K4 equals its plain version on the card and on the CPU on phase
    k4's small cases, and its plain version on the card where it stages
    the columns in several tiles (`chip_smoke.k4_tiled`: many windows a
    block, and at m > 224 256 queries whose tables leave little of the
    block's shared memory)."""
    rng = np.random.default_rng(m)
    args = cs.k4_small(rng, m, cuda)
    cpu_args = cs.k4_to_cpu(args)
    for mode, collect in PERROW_CALLS:
        want = myers_perrow_plain(*args, mode=mode, collect=collect)
        cpu = myers_perrow(*cpu_args, mode=mode, collect=collect)
        before = myers_perrow.launches
        got = myers_perrow(*args, mode=mode, collect=collect)
        assert myers_perrow.launches == before + 1
        for k in want:
            assert torch.equal(got[k], want[k]), (mode, collect, k)
            assert torch.equal(got[k].cpu(), cpu[k]), (mode, collect, k)
    for args in cs.k4_tiled(rng, m, cuda):
        for mode, collect in PERROW_CALLS:
            want = myers_perrow_plain(*args, mode=mode, collect=collect)
            got = myers_perrow(*args, mode=mode, collect=collect)
            for k in want:
                assert torch.equal(got[k], want[k]), (mode, collect, k,
                                                      args[1].shape)


@pytest.mark.gpu
def test_perrow_kernel_calls_ties_on_gpu(cuda):
    """K4 on the tie set and at the decomposer's full-batch step (the 36
    D6Z1 queries against 1,024 windows) equals the plain version, in
    both calls."""
    d6 = read_seqs(D6Z1)
    dec = TDecomposer(d6, device=cuda)
    rows = cs.k4_rows(np.random.default_rng(5), d6, 1024, dec.window, cuda)
    for args in (cs.k4_ties(np.random.default_rng(0), cuda),
                 (dec.queries, *rows)):
        for mode, collect in PERROW_CALLS:
            want = myers_perrow_plain(*args, mode=mode, collect=collect)
            got = myers_perrow(*args, mode=mode, collect=collect)
            for k in want:
                assert torch.equal(got[k], want[k]), (mode, k)


@pytest.mark.gpu
def test_perrow_kernel_rejects_bad_inputs(cuda):
    queries, windows, wlens = cs.k4_small(np.random.default_rng(0), 40,
                                          cuda)
    with pytest.raises(ValueError):                 # m > 256
        perrow_queries(torch.zeros((1, 5, 10), dtype=torch.int64),
                       np.array([300], np.int32), m=300, device=cuda)
    with pytest.raises(TypeError):
        myers_perrow(queries, windows.int(), wlens)
    with pytest.raises(ValueError):
        myers_perrow(queries, windows, wlens.cpu())
    with pytest.raises(ValueError):                 # CPU tables
        myers_perrow(cs.k4_to_cpu((queries, windows, wlens))[0], windows,
                     wlens)


@pytest.mark.gpu
def test_decomposer_on_gpu_matches_cpu(cuda, world):
    monomers, _, reads = world
    d6 = read_seqs(D6Z1)
    rng = np.random.default_rng(2)
    d6_reads = [("d6", add_read_noise(rng, "".join(d6.values()) * 3,
                                      0.08))]
    for mono, rows in ((monomers, reads), (d6, d6_reads)):
        before = myers_perrow.launches
        got = TDecomposer(mono, device=cuda).decompose(rows)
        assert myers_perrow.launches > before
        assert got == TDecomposer(mono, device="cpu").decompose(rows)
