"""The sequence-parallel tier on the port (`parallel/seq_parallel.py`, the
plain version of kernel K5 on the CPU): `myers_distance_seqparallel` on a
`Mesh` of n `cpu` devices (n in {2, 4, 8}) equals the JAX package's on n
of its 8 virtual CPU devices and the port's single-device scan
(`ops/myers.myers_distance_batch`), in HW, SHW and NW modes, on ragged
shapes and on tandem reads of the real DXZ1 unit. The plain K5 chained
over chunks of any size carries the whole state of the unchunked scan.
K5's wrapper checks its lane group, and `pick_group` picks one.
The recruitment engine's seq-par tier (forced by a small
`seq_parallel_min_len`) gives the JAX engine's and the single-device
engine's distances. The `gpu` tests hold K5, at every lane group G,
against its plain version on the card, on the whole carried state."""

import os

import jax
import numpy as np
import pytest
import torch

from centroflye_tpu import config as jconfig
from centroflye_tpu.io import encode as jencode, encode_batch, read_seq
from centroflye_tpu.io.encoding import revcomp_str
from centroflye_tpu.ops.myers import build_peq as jbuild_peq
from centroflye_tpu.parallel import mesh as jmesh_mod
from centroflye_tpu.parallel import seq_parallel as jsp
from centroflye_tpu.pipeline.simulate import add_read_noise, gen_random_seq
from centroflye_tpu.stages import recruitment as jrec

from centroflye_tpu_torch import config as tconfig
from centroflye_tpu_torch.ops.myers import (
    CarryState, carry_init, carry_result, myers_carry_plain,
    myers_distance_batch, words_tensor)
from centroflye_tpu_torch.ops.myers_cuda import (
    GROUPS, myers_carry, pick_group)
from centroflye_tpu_torch.parallel import seq_parallel as tsp
from centroflye_tpu_torch.stages import recruitment as trec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["HW", "SHW", "NW"]


def seq_meshes(n):
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"
    return jsp.make_seq_mesh(n), tsp.make_seq_mesh(n, devices=["cpu"] * n)


def _dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _single(peq, codes, lens, m, mode):
    out = myers_distance_batch(words_tensor(peq, "cpu"),
                               torch.from_numpy(codes),
                               torch.from_numpy(lens), m=m, mode=mode)
    return {k: v.numpy() for k, v in out.items()}


def _assert_equal(a, b):
    for k in ("dist", "end"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_seqparallel_matches_jax_and_single_device(n, mode):
    rng = np.random.default_rng(n)
    unit = _dna(rng, 93)
    peq = jbuild_peq(jencode(unit))
    texts = [_dna(rng, int(rng.integers(40, 300))) for _ in range(10)]
    codes, lens = encode_batch(texts, max_len=304)
    jm, tm = seq_meshes(n)
    want = jsp.myers_distance_seqparallel(peq, codes, lens, m=93, mesh=jm,
                                          mode=mode)
    got = tsp.myers_distance_seqparallel(peq, codes, lens, m=93, mesh=tm,
                                         mode=mode)
    _assert_equal(got, want)
    _assert_equal(got, _single(peq, codes, lens, 93, mode))


@pytest.mark.parametrize("n_micro", [None, 2, 3])
def test_seqparallel_pads_ragged_shapes(n_micro):
    """B and L that divide neither the device count nor the microbatch
    count exercise the padding."""
    rng = np.random.default_rng(4)
    unit = _dna(rng, 40)
    peq = jbuild_peq(jencode(unit))
    codes, lens = encode_batch([_dna(rng, k) for k in (13, 100, 257, 0)],
                               max_len=257)
    jm, tm = seq_meshes(4)
    want = jsp.myers_distance_seqparallel(peq, codes, lens, m=40, mesh=jm,
                                          n_micro=n_micro)
    got = tsp.myers_distance_seqparallel(peq, codes, lens, m=40, mesh=tm,
                                         n_micro=n_micro)
    _assert_equal(got, want)
    _assert_equal(got, _single(peq, codes, lens, 40, "HW"))
    with pytest.raises(ValueError, match="axis"):
        tsp.myers_distance_seqparallel(
            peq, codes, lens, m=40, mesh=tsp.make_seq_mesh(
                2, axis="reads", devices=["cpu"] * 2))


def test_seqparallel_real_unit_tandem_reads():
    """Tandem reads of the real DXZ1 unit (m = 2055, 65 words) and a
    non-centromeric read, columns split over 4 devices."""
    rng = np.random.default_rng(7)
    unit = read_seq(os.path.join(REPO, "centroflye_tpu", "data",
                                 "DXZ1_rc.fasta"))
    peq = jbuild_peq(jencode(unit))
    reads = [add_read_noise(rng, unit * 2, 0.05)[:3000],
             revcomp_str(add_read_noise(rng, unit * 2, 0.05))[:2500],
             "ACGT" * 600]
    codes, lens = encode_batch(reads, max_len=3000)
    jm, tm = seq_meshes(4)
    m = len(unit)
    want = jsp.myers_distance_seqparallel(peq, codes, lens, m=m, mesh=jm,
                                          n_micro=3)
    got = tsp.myers_distance_seqparallel(peq, codes, lens, m=m, mesh=tm,
                                         n_micro=3)
    _assert_equal(got, want)
    assert got["dist"][0] < 0.15 * m and got["dist"][2] > 0.5 * m


# query lengths that put K5's tap word and tap lane at every word and
# lane-group boundary: 1 word, a full word, 2 words, 3 (m = 90), and
# DXZ1's 65, D6Z1's 101 and the largest, 128 (spare slots below word 0 at
# G = 8 and 32, or none)
M_SWEEP = [1, 31, 32, 33, 64, 90, 2055, 3222, 4096]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("m", sorted({70, *M_SWEEP}))
def test_plain_k5_chained_over_chunks_carries_the_whole_state(mode, m):
    """The plain K5 run chunk by chunk (chunks of 1, 7 and 64 columns,
    rows ending inside a chunk, past the text and at 0) ends in the same
    state as one chunk of every column, and its result is the scan's."""
    rng = np.random.default_rng(m)
    peq = words_tensor(jbuild_peq(rng.integers(0, 4, m).astype(np.int8)),
                       "cpu")
    B, L = 6, 150
    text = torch.from_numpy(rng.integers(0, 6, (B, L)).astype(np.int8))
    lens = torch.tensor([L, 0, 1, 77, 149, 200], dtype=torch.int32)
    whole = myers_carry_plain(peq, text, lens, carry_init(B, m, "cpu"), 0,
                              m=m, mode=mode)
    for C in (1, 7, 64):
        st = carry_init(B, m, "cpu")
        for c0 in range(0, L, C):
            st = myers_carry(peq, text[:, c0:c0 + C], lens, st, c0, m=m,
                             mode=mode)
        for a, b in zip(st, whole):
            assert torch.equal(a, b)
    want = myers_distance_batch(peq, text, lens, m=m, mode=mode)
    got = carry_result(whole, lens, mode)
    for k in ("dist", "end"):
        assert torch.equal(got[k], want[k].to(torch.int32)), k


def test_carry_state_and_wrapper_checks():
    st = carry_init(3, 40, "cpu")
    assert isinstance(st, CarryState) and st.vp.shape == (3, 2)
    assert st.vp.dtype == torch.int32 and int(st.vp[0, 0]) == -1
    assert st.score.tolist() == st.best.tolist() == [40] * 3
    assert st.end.tolist() == [-1] * 3
    with pytest.raises(ValueError, match="mode"):
        myers_carry(torch.zeros(5, 2, dtype=torch.int64),
                    torch.zeros(3, 4, dtype=torch.int8),
                    torch.zeros(3, dtype=torch.int32), st, 0, m=40,
                    mode="XX")


def test_k5_group_checks_and_c_signature():
    """`group` is 8, 32 or None, checked before any route: anything else
    raises, on the CPU too, where 8 and 32 give the plain version's state.
    The C entry point takes the group: 9 pointers, 8 ints, the stream."""
    import ctypes

    from centroflye_tpu_torch.ops import _build
    rng = np.random.default_rng(3)
    m = 40
    peq = words_tensor(jbuild_peq(rng.integers(0, 4, m).astype(np.int8)),
                       "cpu")
    text = torch.from_numpy(rng.integers(0, 5, (3, 50)).astype(np.int8))
    lens = torch.tensor([50, 20, 0], dtype=torch.int32)
    st = carry_init(3, m, "cpu")
    want = myers_carry_plain(peq, text, lens, st, 0, m=m)
    for g in (8, 32, None):
        got = myers_carry(peq, text, lens, st, 0, m=m, group=g)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    for g in (0, 1, 16, 64, True, "32"):
        with pytest.raises(ValueError, match="group"):
            myers_carry(peq, text, lens, st, 0, m=m, group=g)
    sig = _build.SIGNATURES["cf_myers_carry"]
    assert len(sig) == 18
    assert sig[:9] == [ctypes.c_void_p] * 9
    assert sig[9:17] == [ctypes.c_int] * 8 and sig[17] is ctypes.c_void_p


@pytest.mark.parametrize("B, G", [(1, 32), (8, 32), (512, 32), (513, 8),
                                  (2048, 8)])
def test_k5_group_rule(B, G):
    """K5's lane group is K1's rule on one strand: G = 32 while each
    row's group has a scheduler (B <= SMALL_BATCH), else G = 8."""
    assert pick_group(B, 1) == G


def _engine_reads(seed):
    rng = np.random.default_rng(seed)
    unit = gen_random_seq(rng, 120)
    lt = add_read_noise(rng, unit * 18, 0.05)
    return unit, [
        ("long_cen", lt), ("long_cen_rc", revcomp_str(lt)),
        ("long_bg", gen_random_seq(rng, 2300)),
        ("short_cen", add_read_noise(rng, unit * 4, 0.05)),
        ("short_bg", gen_random_seq(rng, 900)),
        ("long_n", lt[:1000] + "N" * 20 + lt[1000:])]


@pytest.mark.parametrize("n", [2, 4])
def test_engine_seqpar_tier_equals_jax_and_single_device(n):
    """Reads of at least seq_parallel_min_len take the seq-par tier under
    a mesh (prefilter off, as the JAX package's own test runs it): the
    distances equal the JAX mesh engine's and the single-device
    engine's segmented ones."""
    unit, reads = _engine_reads(n)
    kw = dict(threshold=30, batch_size=8, prefilter=False,
              seq_parallel_min_len=2000)
    want = [(r.r_id, r.dist_fwd, r.dist_rc, r.recruited)
            for r in jrec.RecruitmentEngine(
                unit, jconfig.RecruitmentConfig(**kw), seg_len=1024,
                use_pallas=False,
                mesh=jmesh_mod.make_mesh(n)).run(reads)]
    res = {}
    for tag, mesh in (("mesh", tsp.make_seq_mesh(n, axis="reads",
                                                 devices=["cpu"] * n)),
                      ("single", None)):
        eng = trec.RecruitmentEngine(unit, tconfig.RecruitmentConfig(**kw),
                                     seg_len=1024, device="cpu", mesh=mesh)
        assert eng.seqpar_min == (2000 if mesh else 0)
        res[tag] = [(r.r_id, r.dist_fwd, r.dist_rc, r.recruited)
                    for r in eng.run(reads)]
    assert res["mesh"] == want == res["single"]
    got = {r[0]: r[3] for r in want}
    assert got["long_cen"] and got["long_cen_rc"] and got["short_cen"]
    assert not got["long_bg"] and not got["short_bg"]


# ------------------------------------------------------------ on the card


def k5_against_plain_on_gpu(seed: int):
    """K5 on the card, every G, against its plain version (on the card
    and on the CPU) from a carried mid-read state, every mode, at every m
    of M_SWEEP, rows ending before, inside and past the chunk: the whole
    state must be equal."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    for m in M_SWEEP:
        for mode in MODES:
            B, C = 8, 300
            q = rng.integers(0, 4, m).astype(np.int8)
            peq = words_tensor(jbuild_peq(q), "cpu")
            text = torch.from_numpy(rng.integers(0, 5, (B, 2 * C)).astype(
                np.int8))
            text[0] = torch.from_numpy(np.tile(q, 2 * C // m + 2)[:2 * C])
            lens = torch.tensor([2 * C, 0, C // 2, C + 5, 2 * C - 1, 2 * C,
                                 C, 5 * C], dtype=torch.int32)
            mid = myers_carry_plain(peq, text[:, :C], lens,
                                    carry_init(B, m, "cpu"), 0, m=m,
                                    mode=mode)
            want = myers_carry_plain(peq, text[:, C:], lens, mid, C, m=m,
                                     mode=mode)
            args = (peq.to(dev), text[:, C:].to(dev), lens.to(dev),
                    mid.to(dev), C)
            on_card = myers_carry_plain(*args, m=m, mode=mode)
            for g in GROUPS:
                before = myers_carry.launches
                got = myers_carry(*args, m=m, mode=mode, group=g)
                assert myers_carry.launches == before + 1
                for a, w, p in zip(got, want, on_card):
                    assert torch.equal(a.cpu(), w) and torch.equal(a, p), \
                        (m, mode, g)


@pytest.mark.gpu
def test_k5_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K5 has no CPU mode")
    k5_against_plain_on_gpu(seed=0)
