"""The port's Myers: plain `myers_distance_batch` (shared and per-row
queries, per-row lengths, collect "best" and "all") against the JAX scan
and the DP oracle, and the two-strand kernel's plain version against the
JAX Pallas kernel (interpret mode). Exact: distances, ends and scores are
integers. The CUDA kernel itself is compared with its plain version in
the `gpu` tests, which skip without a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroflye_tpu.io import encoding as jenc
from centroflye_tpu.ops import myers as jmyers
from centroflye_tpu.ops.myers_pallas_v3 import myers_hw_pallas_v3_2strand

from centroflye_tpu_torch.ops.myers import (build_peq,
                                            edit_distance_oracle,
                                            myers_distance_batch,
                                            words_tensor)
from centroflye_tpu_torch.ops.myers_cuda import (
    myers_hw_2strand, myers_hw_2strand_plain, recruit_distances)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _dna(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _texts(rng, q, n_random=5):
    """Random texts plus the hard rows: the query itself, a mutated copy
    with an N run, all-N, empty, shorter than the query."""
    mid = len(q) // 2
    texts = [_dna(rng, 7) + q + _dna(rng, 5),
             q[:mid] + "NNN" + q[mid:],
             "N" * 12, "", q[: max(1, len(q) // 3)]]
    texts += [_dna(rng, int(n)) for n in rng.integers(1, len(q) + 40,
                                                      n_random)]
    return texts


@pytest.mark.parametrize("mode", ["HW", "SHW", "NW"])
@pytest.mark.parametrize("m", [1, 31, 32, 33, 90, 300])
def test_myers_distance_batch_matches_jax_and_oracle(m, mode):
    rng = np.random.default_rng(1000 + m)
    q = _dna(rng, m)
    texts = _texts(rng, q)
    codes, lens = jenc.encode_batch(texts)
    lens[3] = 0                                # the empty row
    peq = build_peq(jenc.encode(q))
    got = myers_distance_batch(words_tensor(peq, "cpu"),
                               torch.from_numpy(codes),
                               torch.from_numpy(lens), m=m, mode=mode)
    want = jmyers.myers_distance_batch(jnp.asarray(peq), jnp.asarray(codes),
                                       jnp.asarray(lens), m=m, mode=mode)
    assert got["dist"].dtype == torch.int32
    np.testing.assert_array_equal(got["dist"].numpy(), np.asarray(want["dist"]))
    np.testing.assert_array_equal(got["end"].numpy(), np.asarray(want["end"]))
    oracle_rows = range(len(texts)) if m <= 90 else range(4)
    for i in oracle_rows:
        d, e = jmyers.edit_distance_oracle(q, texts[i], mode)
        assert int(got["dist"][i]) == d, (i, texts[i][:20])
        assert int(got["end"][i]) == e, (i, texts[i][:20])


def test_myers_distance_batch_ignores_columns_past_len():
    rng = np.random.default_rng(5)
    q = _dna(rng, 40)
    codes, lens = jenc.encode_batch([q + q, q + q])
    lens[1] = 30                     # the query lies past row 1's length
    peq = words_tensor(build_peq(jenc.encode(q)), "cpu")
    out = myers_distance_batch(peq, torch.from_numpy(codes),
                               torch.from_numpy(lens), m=40)
    d, e = jmyers.edit_distance_oracle(q, (q + q)[:30])
    assert out["dist"].tolist() == [0, d]
    assert out["end"].tolist() == [39, e]


def test_myers_rejects_unported_modes():
    """Per-row queries and collect="all", once rejected, now run and
    equal the JAX scan; malformed ms and peq shapes are rejected."""
    rng = np.random.default_rng(4)
    q = [jenc.encode(_dna(rng, 4)), jenc.encode(_dna(rng, 3))]
    peq = np.stack([build_peq(q[0], 4), build_peq(q[1], 4)])
    codes = rng.integers(0, 5, (2, 6)).astype(np.int8)
    lens = np.array([6, 4], np.int32)
    ms = np.array([4, 3], np.int32)
    got = myers_distance_batch(words_tensor(peq, "cpu"),
                               torch.from_numpy(codes),
                               torch.from_numpy(lens), m=4, collect="all",
                               ms=torch.from_numpy(ms))
    want = jmyers.myers_distance_batch(
        jnp.asarray(peq), jnp.asarray(codes), jnp.asarray(lens), m=4,
        collect="all", ms=jnp.asarray(ms))
    np.testing.assert_array_equal(got["scores"].numpy(),
                                  np.asarray(want["scores"]))
    for bad_ms in ([0, 3], [5, 3]):
        with pytest.raises(ValueError, match="ms"):
            myers_distance_batch(words_tensor(peq, "cpu"),
                                 torch.from_numpy(codes),
                                 torch.from_numpy(lens), m=4,
                                 ms=torch.tensor(bad_ms))
    with pytest.raises(ValueError, match="peq shape"):
        myers_distance_batch(words_tensor(peq[:1], "cpu"),
                             torch.from_numpy(codes),
                             torch.from_numpy(lens), m=4)


@pytest.mark.parametrize("mode", ["HW", "SHW", "NW"])
@pytest.mark.parametrize("m", [1, 32, 33, 70, 300])
def test_myers_per_row_queries_match_jax(m, mode):
    """(B, 5, W) per-row queries with per-row lengths ms <= m (ms < m on
    most rows), collect "best" and "all", against the JAX scan."""
    rng = np.random.default_rng(2000 + m)
    B, L = 9, m + 40
    ms = rng.integers(1, m + 1, B).astype(np.int32)
    ms[0] = m
    queries = [_dna(rng, int(n)) for n in ms]
    peq = np.stack([build_peq(jenc.encode(q), m) for q in queries])
    texts = [_dna(rng, 5) + queries[b] + _dna(rng, 5) if b % 3 == 0
             else _dna(rng, int(rng.integers(0, L + 1))) for b in range(B)]
    texts[1] = texts[1][:3] + "NN" + texts[1][5:]
    codes, lens = jenc.encode_batch(texts, max_len=L)
    lens = np.minimum(lens, L).astype(np.int32)
    args_t = (words_tensor(peq, "cpu"), torch.from_numpy(codes),
              torch.from_numpy(lens))
    args_j = (jnp.asarray(peq), jnp.asarray(codes), jnp.asarray(lens))
    for collect in ("best", "all"):
        got = myers_distance_batch(*args_t, m=m, mode=mode, collect=collect,
                                   ms=torch.from_numpy(ms))
        want = jmyers.myers_distance_batch(*args_j, m=m, mode=mode,
                                           collect=collect,
                                           ms=jnp.asarray(ms))
        assert want.keys() == got.keys()
        for key in want:
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]),
                                          err_msg=f"{collect} {key}")
    if mode != "NW":
        for b in (0, 3):
            d, e = jmyers.edit_distance_oracle(queries[b], texts[b], mode)
            best = myers_distance_batch(*args_t, m=m, mode=mode,
                                        ms=torch.from_numpy(ms))
            assert (int(best["dist"][b]), int(best["end"][b])) == (d, e)


@pytest.mark.parametrize("mode", ["HW", "SHW", "NW"])
def test_collect_all_shared_query_matches_jax(mode):
    """collect="all" with one shared query: masked columns, including
    those past every row's length, repeat the last score."""
    rng = np.random.default_rng(77)
    q = _dna(rng, 45)
    codes, lens = jenc.encode_batch(_texts(rng, q), max_len=90)
    peq = build_peq(jenc.encode(q))
    got = myers_distance_batch(words_tensor(peq, "cpu"),
                               torch.from_numpy(codes),
                               torch.from_numpy(lens), m=45, mode=mode,
                               collect="all")
    want = jmyers.myers_distance_batch(jnp.asarray(peq), jnp.asarray(codes),
                                       jnp.asarray(lens), m=45, mode=mode,
                                       collect="all")
    np.testing.assert_array_equal(got["scores"].numpy(),
                                  np.asarray(want["scores"]))
    assert got["scores"].shape == (codes.shape[0], 90)


@pytest.mark.parametrize("mode", ["HW", "SHW", "NW"])
def test_edit_distance_oracle_matches_jax(mode):
    rng = np.random.default_rng(31)
    for _ in range(6):
        q = _dna(rng, int(rng.integers(1, 40)))
        for t in _texts(rng, q, n_random=2):
            assert edit_distance_oracle(q, t, mode) == \
                jmyers.edit_distance_oracle(q, t, mode), (q, t)


def _kernel_case(seed, m, L, B):
    """Ragged 2-strand batch of B >= 10 rows: lens 0, lens < m, N runs,
    tandem rows on both strands, random rows."""
    rng = np.random.default_rng(seed)
    q = jenc.encode(_dna(rng, m))
    qr = jenc.revcomp(q)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    reps = L // m + 1
    codes[0] = np.tile(q, reps)[:L]
    codes[1] = np.tile(qr, reps)[:L]
    codes[2, 10:10 + min(m, L - 10)] = q[:L - 10]
    codes[2, 20:30] = 4
    codes[3:8, :] = 4
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:3] = L
    lens[8] = 0
    lens[9] = max(1, m // 2)
    return build_peq(q), build_peq(qr), codes, lens


def test_2strand_plain_matches_pallas_interpret():
    m, L, B = 90, 256, 128
    pf, pr, codes, lens = _kernel_case(7, m, L, B)
    want = myers_hw_pallas_v3_2strand(
        jnp.asarray(pf), jnp.asarray(pr), jnp.asarray(codes.T),
        jnp.asarray(lens).reshape(-1, 1), m=m, interpret=True)
    text_t = torch.from_numpy(codes.T.copy())
    lens_t = torch.from_numpy(lens).reshape(-1, 1)
    got = myers_hw_2strand_plain(words_tensor(pf, "cpu"),
                                 words_tensor(pr, "cpu"), text_t, lens_t, m=m)
    for k in ("dist_f", "end_f", "dist_r", "end_r"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert int(got["dist_f"][0]) == 0 and int(got["dist_r"][1]) == 0
    assert (int(got["dist_f"][8]), int(got["end_f"][8])) == (m, -1)


def test_2strand_wrapper_on_cpu_is_the_plain_version():
    m, L, B = 33, 64, 16
    pf, pr, codes, lens = _kernel_case(3, m, L, B)
    args = (words_tensor(pf, "cpu"), words_tensor(pr, "cpu"),
            torch.from_numpy(codes.T.copy()), torch.from_numpy(lens))
    before = myers_hw_2strand.launches
    got = myers_hw_2strand(*args, m=m)
    want = myers_hw_2strand_plain(*args, m=m)
    assert myers_hw_2strand.launches == before     # no kernel launched
    for k in want:
        assert torch.equal(got[k], want[k]), k
    df, dr = recruit_distances(args[0], args[1], torch.from_numpy(codes),
                               args[3], m=m)
    assert torch.equal(df, want["dist_f"]) and torch.equal(dr, want["dist_r"])
    for group in (8, 32):
        forced = myers_hw_2strand(*args, m=m, group=group)
        assert all(torch.equal(forced[k], want[k]) for k in want)
    for group in (12, 16):
        with pytest.raises(ValueError, match="group"):
            myers_hw_2strand(*args, m=m, group=group)
    assert myers_hw_2strand.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("group", [None, 8, 32])
@pytest.mark.parametrize("m,L,B", [(1, 64, 12), (33, 200, 130), (90, 256, 128),
                                   (2055, 10240, 128), (2055, 2600, 2048),
                                   (3200, 3600, 10)])
def test_2strand_kernel_matches_plain_on_gpu(cuda, m, L, B, group):
    """Every instance (G lanes per row and strand; None: the wrapper's
    pick, 8 at the exact tier's 2048 rows) equals the plain version."""
    pf, pr, codes, lens = _kernel_case(m, m, L, B)
    args = (words_tensor(pf, cuda), words_tensor(pr, cuda),
            torch.from_numpy(codes.T.copy()).to(cuda),
            torch.from_numpy(lens).to(cuda))
    before = myers_hw_2strand.launches
    got = myers_hw_2strand(*args, m=m, group=group)
    torch.cuda.synchronize()
    assert myers_hw_2strand.launches == before + 1
    want = myers_hw_2strand_plain(*args, m=m)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    cpu = myers_hw_2strand(*(a.cpu() for a in args), m=m)
    for k in want:
        assert torch.equal(got[k].cpu(), cpu[k]), k


@pytest.mark.gpu
def test_2strand_kernel_rejects_bad_inputs(cuda):
    pf, pr, codes, lens = _kernel_case(1, 40, 64, 16)
    pf_t, pr_t = words_tensor(pf, cuda), words_tensor(pr, cuda)
    text_t = torch.from_numpy(codes.T.copy()).to(cuda)
    lens_t = torch.from_numpy(lens).to(cuda)
    with pytest.raises(TypeError):
        myers_hw_2strand(pf_t, pr_t, text_t.int(), lens_t, m=40)
    with pytest.raises(ValueError):
        myers_hw_2strand(pf_t, pr_t, text_t, lens_t.cpu(), m=40)
    with pytest.raises(ValueError):
        myers_hw_2strand(pf_t, pr_t, text_t.t(), lens_t, m=40)
    with pytest.raises(ValueError):
        myers_hw_2strand(pf_t, pr_t, text_t, lens_t, m=4097)
    with pytest.raises(ValueError, match="group"):
        myers_hw_2strand(pf_t, pr_t, text_t, lens_t, m=40, group=4)
