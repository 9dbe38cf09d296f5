"""K3's two-pass plan (`banded_plan`): a prefix filter on the first r0
query rows, then an exact pass over column windows on the survivors.
`myers_hw_v3_banded_split_plain` carries the plan out in plain torch;
every case here holds it against the JAX Pallas kernel
`myers_hw_pallas_v3_banded` in interpret mode and against the plain
threshold (`myers_hw_v3_banded_plain`), exactly. The `gpu` tests hold
the CUDA kernel against the plain version under forced plans."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroflye_tpu.ops.myers_pallas_v3 import myers_hw_pallas_v3_banded

from centroflye_tpu_torch.io.encoding import decode, encode, revcomp
from centroflye_tpu_torch.ops.myers import (build_peq, myers_distance_batch,
                                            words_tensor)
from centroflye_tpu_torch.ops.myers_cuda import (
    ALPHA, MIN_WINDOW, SMALL_BATCH, BandedRun, _window_minima,
    banded_plan, myers_hw_v3, myers_hw_v3_banded, myers_hw_v3_banded_plain,
    myers_hw_v3_banded_split_plain, myers_hw_v3_plain, threshold_hw)
from centroflye_tpu_torch.pipeline.simulate import add_read_noise

B = 128                 # the Pallas kernel's row tile
L_BY_M = {23: 128, 90: 224, 300: 400}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _banded_case(seed, m, L, rows=B):
    """(query codes, codes (rows, L), lens): noisy tandem copies of the
    query and of its reverse complement; random bases, then tandem
    copies; tandem copies cut by N runs every 50 columns (across any
    window edge); a copy of the first half of the query or of its
    reverse complement in random text (passes a short prefix, fails in
    full); random rows with random lens; lens 0, 5, m-1 and m/2; two
    exact copies of the query (a tie, whose first column counts)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, m).astype(np.int8)
    reps = L // m + 2
    strands = [decode(q) * reps, decode(revcomp(q)) * reps]
    codes = rng.integers(0, 4, (rows, L)).astype(np.int8)
    lens = np.full(rows, L, np.int32)
    for r in range(rows):
        src = strands[(r // 8) % 2]
        kind = r % 8
        if kind in (0, 1):
            row = encode(add_read_noise(rng, strands[kind],
                                        float(rng.uniform(0.01, 0.3))))
        elif kind == 2:
            pre = int(rng.integers(0, max(1, L - m)))
            row = np.concatenate([codes[r, :pre],
                                  encode(add_read_noise(rng, src, 0.05))])
        elif kind == 3:
            row = encode(add_read_noise(rng, src, 0.03))
            for s in range(int(rng.integers(0, 50)), L, 50):
                row[s:s + 12] = 4
        elif kind in (4, 5):
            part = (q if kind == 4 else revcomp(q))[:m // 2]
            s = int(rng.integers(0, max(1, L - len(part))))
            row = codes[r].copy()
            row[s:s + len(part)] = part[:L - s]
        elif kind == 6:
            lens[r] = int(rng.integers(0, L + 1))
            continue
        else:
            continue
        codes[r] = row[:L]
    j1, j2 = L // 3, 2 * L // 3
    codes[rows - 5] = rng.integers(0, 4, L)
    for j in (j1, j2):                       # exact copies ending at j
        if j + 1 >= m:
            codes[rows - 5, j + 1 - m:j + 1] = q
    lens[rows - 1] = 0
    lens[rows - 2] = min(m - 1, L)
    lens[rows - 3] = max(1, m // 2)
    lens[rows - 4] = 5
    return q, codes, lens


def _torch_args(peq, codes, lens, device="cpu"):
    return (words_tensor(peq, device),
            torch.from_numpy(codes.T.copy()).to(device),
            torch.from_numpy(lens).to(device))


@functools.lru_cache(maxsize=None)
def _case_and_jax(seed, m, L, k, strand):
    """The case's torch arguments (peq of the query or of its reverse
    complement) and the Pallas kernel's outputs at k, in interpret mode."""
    q, codes, lens = _banded_case(seed, m, L)
    peq = build_peq(q if strand == "f" else revcomp(q))
    want = myers_hw_pallas_v3_banded(
        jnp.asarray(peq), jnp.asarray(codes.T),
        jnp.asarray(lens).reshape(-1, 1), m=m, k=k, interpret=True)
    want = {key: np.asarray(v) for key, v in want.items()}
    return _torch_args(peq, codes, lens), want


def _assert_equal(got, want, msg=""):
    for key in ("dist", "end"):
        assert got[key].dtype == torch.int32
        w = want[key]
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_array_equal(got[key].cpu().numpy(), w,
                                      err_msg=f"{key} {msg}")


def _forced_plans(m, k, L):
    """(prefix_rows, window) pairs: the plan's own, then r0 in {32, 64, m}
    (those <= m) with S below pass 1's overlap and S = L, and at r0 = m
    also S = L / 3."""
    plans = [(None, None)]
    for r0 in sorted({32, 64, m}):
        if r0 > m:
            continue
        below = max(1, (r0 + k - 1) // 2)
        mid = {max(below + 1, L // 3)} if r0 == m else set()
        plans += [(r0, S) for S in sorted({below, L} | mid)]
    return plans


@pytest.mark.parametrize("m,k,strand", [
    (m, k, s) for m in (23, 90, 300) for k in (0, 20, m)
    for s in (("f", "r") if k == 20 else ("f",))])
def test_split_plain_matches_pallas_and_plain(m, k, strand):
    L = L_BY_M[m]
    args, want = _case_and_jax(m, m, L, k, strand)
    plain = myers_hw_v3_banded_plain(*args, m=m, k=k)
    _assert_equal(plain, want, "plain vs Pallas")
    for prefix_rows, window in _forced_plans(m, k, L):
        got = myers_hw_v3_banded_split_plain(*args, m=m, k=k,
                                             prefix_rows=prefix_rows,
                                             window=window)
        _assert_equal(got, want, f"r0={prefix_rows} S={window}")
    in_band = int((plain["dist"] < m).sum())
    if k == 20 and m >= 90:
        assert 0 < in_band < B        # both sides of k


def test_prefix_survivors_are_the_rows_within_k_on_the_prefix():
    """Pass 1 keeps exactly the rows whose prefix distance is <= k, and
    some of them fail in full (a copy of the query's first rows only)."""
    m, k, r0 = 300, 20, 64
    L = L_BY_M[m]
    args, want = _case_and_jax(m, m, L, k, "f")
    peq, text_t, lens = args
    prefix = myers_distance_batch(peq[:, :r0 // 32].contiguous(), text_t.t(),
                                  lens, m=r0)
    for window in (None, 40):
        got = myers_hw_v3_banded_split_plain(*args, m=m, k=k,
                                             prefix_rows=r0, window=window)
        _assert_equal(got, want, f"S={window}")
        survivors = got["survivors"].tolist()
        assert survivors == torch.nonzero(prefix["dist"] <= k)[:, 0].tolist()
        failed = [r for r in survivors if int(got["dist"][r]) == m]
        assert len(failed) >= 4
        assert all(int(got["end"][r]) == -1 for r in failed)


def _tie_case(m=90, L=384):
    """Rows with two exact copies of the query, ending at j1 < j2; j1
    lies in window 1's owned columns (S = 128) and j2 in window 2's, so
    two windows report a distance 0. Window 2 (scored from 167 - k)
    starts before the first copy in row 0 at k = 20 and so scores j1
    exactly too; in row 1 it starts after it. Row 4 is row 0 with one
    substitution in each copy: a tie at distance 1."""
    rng = np.random.default_rng(11)
    q = rng.integers(0, 4, m).astype(np.int8)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    ends = {0: (249, 359), 1: (189, 359), 2: (150, 255), 3: (255, 256 + m)}
    for r, js in ends.items():
        for j in js:
            codes[r, j + 1 - m:j + 1] = q
    codes[4] = codes[0]
    codes[4, 249 - m + 1] = (codes[4, 249 - m + 1] + 1) % 4   # ties at 1
    codes[4, 359] = (codes[4, 359] + 1) % 4
    return q, codes, np.full(B, L, np.int32), ends


@pytest.mark.parametrize("k", [1, 20])
def test_tie_in_window_overlap_reports_first_column(k):
    m, L, S = 90, 384, 128
    q, codes, lens, ends = _tie_case(m, L)
    args = _torch_args(build_peq(q), codes, lens)
    want = myers_hw_pallas_v3_banded(
        jnp.asarray(build_peq(q)), jnp.asarray(codes.T),
        jnp.asarray(lens).reshape(-1, 1), m=m, k=k, interpret=True)
    _assert_equal(myers_hw_v3_banded_plain(*args, m=m, k=k), want)
    for prefix_rows in (32, m):
        got = myers_hw_v3_banded_split_plain(*args, m=m, k=k,
                                             prefix_rows=prefix_rows,
                                             window=S)
        _assert_equal(got, want, f"r0={prefix_rows}")
        for r, (j1, _) in ends.items():
            assert (int(got["dist"][r]), int(got["end"][r])) == (0, j1)
        if k >= 1:
            assert (int(got["dist"][4]), int(got["end"][4])) == (1, 249)


def test_window_overlap_q_plus_k_minus_1_is_needed():
    """An alignment of cost k with k insertions spans q + k columns: a
    window scored from one column later than the rule misses it."""
    m, k, S, L = 64, 6, 128, 384
    rng = np.random.default_rng(5)
    q = rng.integers(0, 4, m).astype(np.int8)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    row = np.insert(q, np.arange(8, 8 + 8 * k, 8), 0).astype(np.int8)
    assert len(row) == m + k
    end = 2 * S                            # window 2's first column
    codes[0, end + 1 - len(row):end + 1] = row
    lens = np.full(B, L, np.int32)
    args = _torch_args(build_peq(q), codes, lens)
    want = myers_hw_pallas_v3_banded(
        jnp.asarray(build_peq(q)), jnp.asarray(codes.T),
        jnp.asarray(lens).reshape(-1, 1), m=m, k=k, interpret=True)
    got = myers_hw_v3_banded_split_plain(*args, m=m, k=k, window=S)
    _assert_equal(got, want)
    assert (int(got["dist"][0]), int(got["end"][0])) == (k, end)
    plan = banded_plan(m, k, L, B, prefix_rows=m, window=S).pass1
    assert plan.q == m and plan.overlap == m + k - 1
    assert end + 1 - len(row) == 2 * S - plan.overlap     # c0 of window 2
    rows = torch.arange(B)
    exact, _ = _window_minima(*args, plan, rows, k)
    short, _ = _window_minima(*args, plan._replace(overlap=plan.overlap - 1),
                              rows, k)
    assert int(exact[0]) == (k << 32) | end
    assert int(short[0] >> 32) > k        # the copy's first column is lost


@pytest.mark.parametrize("m,k,L,rows,window", [
    (2055, 350, 10240, 2048, None), (2055, 350, 10240, 128, None),
    (2055, 350, 10240, 40, None), (2055, 350, 10240, 1, None),
    (90, 20, 256, 128, 17), (90, 0, 256, 128, 1), (23, 23, 160, 128, 160),
    (300, 300, 480, 128, 1000), (40, 5, 0, 16, None), (33, 3, 64, 0, None)])
def test_banded_plan_windows_cover_the_columns(m, k, L, rows, window):
    plan = banded_plan(m, k, L, rows, window=window)
    want_r0 = min(m, 32 * math.ceil(ALPHA * (k + 1) / 32))
    assert plan.r0 == want_r0 and (plan.r0 % 32 == 0 or plan.r0 == m)
    assert (plan.pass2 is None) == (plan.r0 == m)
    passes = [plan.pass1] + ([plan.pass2] if plan.pass2 else [])
    for p, q in zip(passes, (plan.r0, m)):
        assert p.q == q and p.rows == rows and p.L == L
        assert p.overlap == q + k - 1
        assert p.problems == rows * p.windows
        spans = p.spans()
        assert len(spans) == p.windows >= 1
        owned = [c for _, lo, hi in spans for c in range(lo, hi)]
        assert owned == list(range(L))            # a partition of [0, L)
        for c0, lo, hi in spans:
            assert lo < hi or L == 0
            assert c0 == max(0, lo - (q + k - 1))
        if window is not None:
            assert p.S == max(1, min(window, L))
        elif rows * 2 > SMALL_BATCH:
            assert p.windows == 1
        else:
            assert p.S >= min(MIN_WINDOW, L)
            assert p.problems <= max(SMALL_BATCH, rows)


def test_banded_plan_at_the_exact_tier():
    """DXZ1 (m = 2055) at k = 350: a 28-word prefix; 2048 rows in one
    window a row; 40 survivors in windows of 1024 owned columns."""
    plan = banded_plan(2055, 350, 10240, 2048, survivors=40)
    assert plan.r0 == 896
    assert (plan.pass1.windows, plan.pass1.S) == (1, 10240)
    assert (plan.pass2.rows, plan.pass2.windows, plan.pass2.S) == (40, 10, 1024)
    assert plan.pass2.overlap == 2055 + 349
    assert banded_plan(2055, 350, 10240, 2048, alpha=2.0).r0 == 704
    assert banded_plan(2055, 350, 10240, 2048, alpha=3.0).r0 == 1056
    assert banded_plan(2055, 2055, 10240, 2048).pass2 is None


@pytest.mark.parametrize("kw", [
    {"prefix_rows": 0}, {"prefix_rows": 48}, {"prefix_rows": 128},
    {"prefix_rows": 2.0}, {"prefix_rows": True}, {"window": 0},
    {"window": -3}, {"window": 8.0}, {"k": -1}, {"k": 101}])
def test_banded_plan_rejects_bad_overrides(kw):
    args = dict(m=100, k=10, L=256, B=16)
    args.update(kw)
    with pytest.raises(ValueError):
        banded_plan(args.pop("m"), args.pop("k"), args.pop("L"),
                    args.pop("B"), **args)


def test_banded_wrapper_on_cpu_is_the_plain_version():
    m, L = 90, 256
    args, want = _case_and_jax(m, m, L, 20, "f")
    before = (myers_hw_v3.launches, myers_hw_v3_banded.launches)
    for prefix_rows, window in _forced_plans(m, 20, L):
        got = myers_hw_v3_banded(*args, m=m, k=20, prefix_rows=prefix_rows,
                                 window=window)
        _assert_equal(got, want)
    assert (myers_hw_v3.launches, myers_hw_v3_banded.launches) == before
    with pytest.raises(ValueError, match="prefix_rows"):
        myers_hw_v3_banded(*args, m=m, k=20, prefix_rows=40)
    with pytest.raises(ValueError, match="window"):
        myers_hw_v3_banded(*args, m=m, k=20, window=0)
    with pytest.raises(ValueError, match="k=-1"):
        myers_hw_v3_banded_split_plain(*args, m=m, k=-1)
    with pytest.raises(ValueError):
        BandedRun(*args, m=m, k=20)       # no kernel for CPU tensors


# -- on the card ------------------------------------------------------------

GPU_SHAPES = [(23, 160, 128), (90, 256, 128), (300, 480, 128),
              (2055, 10240, 128), (2055, 2600, 2048), (1500, 3000, 40)]


def _gpu_plans(m, k, L):
    """The plan's own; pass 1 only (r0 = m); windows in both passes
    (a small S); a 32-row prefix with S = L (one window)."""
    small = max(1, (32 + k) // 2)
    return [(None, None), (m, None), (m, small), (32 if m > 32 else m, small),
            (32 if m > 32 else m, L)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,L,rows", GPU_SHAPES)
def test_banded_kernel_matches_plain_under_forced_plans(cuda, m, L, rows):
    q, codes, lens = _banded_case(m + 7, m, L, rows)
    args = _torch_args(build_peq(q), codes, lens, device=cuda)
    unbanded = myers_hw_v3_plain(*args, m=m)
    for k in (0, 20, 350, m):
        kk = min(k, m)
        for prefix_rows, window in _gpu_plans(m, kk, L):
            want = threshold_hw(unbanded, m=m, k=k)
            before = myers_hw_v3_banded.launches
            got = myers_hw_v3_banded(*args, m=m, k=k,
                                     prefix_rows=prefix_rows, window=window)
            torch.cuda.synchronize()
            assert myers_hw_v3_banded.launches == before + 1
            _assert_equal(got, want, f"k={k} r0={prefix_rows} S={window}")
            run = BandedRun(*args, m=m, k=k, prefix_rows=prefix_rows,
                            window=window)
            run.pass1()
            run.pass2()
            _assert_equal(run.result(), want, "BandedRun")
            if m <= 300:
                model = myers_hw_v3_banded_split_plain(
                    *(a.cpu() for a in args), m=m, k=k,
                    prefix_rows=prefix_rows, window=window)
                _assert_equal(got, model)
                n = None if model["survivors"] is None \
                    else len(model["survivors"])
                assert run.survivors == n


@pytest.mark.gpu
def test_banded_kernel_with_zero_survivors(cuda):
    """Random rows at k = 0 on a 64-row prefix: no row survives pass 1,
    pass 2 launches only the outputs' kernel, all (m, -1)."""
    m, L, rows = 300, 2000, 256
    rng = np.random.default_rng(4)
    q = rng.integers(0, 4, m).astype(np.int8)
    codes = rng.integers(0, 4, (rows, L)).astype(np.int8)
    args = _torch_args(build_peq(q), codes, np.full(rows, L, np.int32),
                       device=cuda)
    for window in (None, 100):
        run = BandedRun(*args, m=m, k=0, prefix_rows=64, window=window)
        run.pass1()
        run.pass2()
        torch.cuda.synchronize()
        assert run.survivors == 0 and run.plan.pass2.problems == 0
        assert bool((run.result()["dist"] == m).all())
        assert bool((run.result()["end"] == -1).all())
        _assert_equal(run.result(), myers_hw_v3_banded_plain(*args, m=m, k=0))
