"""The port's monomer decomposer (`mono/string_decomposer.py`, its CPU
path: the plain version of kernel K4) against the JAX package's, on the
same reads: equal records row for row, for exact, noisy and
reverse-strand reads of tests/test_mono_e2e.py's world, the real D6Z1
monomers on a 2-HOR read, lockstep batches of 1, 4 and 32 reads, and
reads that make gap steps (no alignment progress). Also: K4's wrapper on
the CPU equals the JAX package's `myers_distance_batch` on the
decomposer's row layout (`np.repeat` of the windows beside `np.tile` of
the queries), and `convert.decomposer_state_from_numpy` carries the JAX
decomposer's tables into the port's. Tests marked `gpu` hold K4 against
its plain version and the card's decomposer against the CPU's."""

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


@pytest.mark.parametrize("batch_reads", [1, 4, 32])
def test_records_equal_jax(world, batch_reads):
    monomers, syms, reads = world
    want = JDecomposer(monomers, JConfig(batch_reads=batch_reads)
                       ).decompose(reads)
    got = TDecomposer(monomers, TConfig(batch_reads=batch_reads),
                      device="cpu").decompose(reads)
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


@pytest.mark.parametrize("m", [1, 31, 32, 33, 64, 256])
def test_perrow_plain_equals_jax_layout(m):
    """K4's wrapper on CPU tensors (its plain version) gives the JAX
    `myers_distance_batch` on the decomposer's layout, in both of the
    decomposer's calls, on phase k4's small cases (`chip_smoke.k4_small`);
    any other call raises."""
    args = cs.k4_small(np.random.default_rng(m), m, "cpu")
    queries, windows, wlens = args
    peqs = queries.peqs.numpy().astype(np.uint32)
    ms, windows, wlens = queries.ms.numpy(), windows.numpy(), wlens.numpy()
    R, Q = len(windows), len(peqs)
    for mode, collect in PERROW_CALLS:
        want = jmyers(np.tile(peqs, (R, 1, 1)), np.repeat(windows, Q, 0),
                      np.repeat(wlens, Q), m=m, mode=mode,
                      ms=np.tile(ms, R), collect=collect)
        got = myers_perrow(*args, mode=mode, collect=collect)
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for mode, collect in (("XX", "best"), ("HW", "best"), ("NW", "best"),
                          ("SHW", "all")):
        with pytest.raises(ValueError):
            myers_perrow(*args, mode=mode, collect=collect)


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
    args = cs.k4_small(np.random.default_rng(m), m, cuda)
    cpu_args = cs.k4_to_cpu(args)
    for mode, collect in PERROW_CALLS:
        before = myers_perrow.launches
        got = myers_perrow(*args, mode=mode, collect=collect)
        assert myers_perrow.launches == before + 1
        want = myers_perrow_plain(*args, mode=mode, collect=collect)
        cpu = myers_perrow(*cpu_args, mode=mode, collect=collect)
        for k in want:
            assert torch.equal(got[k], want[k]), (mode, collect, k)
            assert torch.equal(got[k].cpu(), cpu[k]), (mode, collect, k)


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
