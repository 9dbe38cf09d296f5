"""The fused step's chunked survivor scorer (`ops/myers_cuda.myers_hw_chunks`
behind `ops/fused_recruit.score_chunked`). On the CPU: the least of the
plain version's distances over a row's `chunk_windows` is the row's whole
HW distance on both strands (the native DP, an independent version), for
planted unit copies across chunk boundaries, distances far above any
threshold and every kind of row length; and the scorer's bundle equals the
whole-row scoring's. On the card (`gpu`): the kernel's bundle equals the
one K1 gives on whole rows at the fused step's shape."""

import numpy as np
import pytest
import torch

from centroflye_tpu_torch import DATA_DIR
from centroflye_tpu_torch.io.encoding import encode, revcomp
from centroflye_tpu_torch.io.fasta import read_seq
from centroflye_tpu_torch.native import native_edit_distance_batch
from centroflye_tpu_torch.ops.fused_recruit import (_unpack_2bit, pack_2bit,
                                                    score_chunked)
from centroflye_tpu_torch.ops.myers import (build_peq, int32_words,
                                            words_tensor)
from centroflye_tpu_torch.ops.myers_cuda import (
    CHUNK_ALIGN, CHUNK_MIN, chunk_columns, chunk_windows, myers_hw_chunks,
    recruit_distances)
from centroflye_tpu_torch.pipeline.simulate import add_read_noise

SEG = 32768         # the fused step's rows (recruit_file's segment length)
K_BUDGET = 128


@pytest.fixture(autouse=True)
def one_thread():
    """The plain version's column loop is thousands of small operations:
    one thread, so that parallel test workers do not oversubscribe the
    cores (eight threads each made this file twenty times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _unit(name_or_m, rng):
    if isinstance(name_or_m, str):
        return encode(read_seq(f"{DATA_DIR}/{name_or_m}.fasta"))
    return rng.integers(0, 4, name_or_m).astype(np.int8)


def _noisy(rng, codes, rate):
    return encode(add_read_noise(rng, "".join("ACGT"[c] for c in codes),
                                 rate))


def _rows(rng, unit, L, C, n_planted=3):
    """(R, L) int8 codes and (R,) lens: noisy copies of the unit and of
    its reverse complement planted at c0 - m, c0 and c0 + m around a
    chunk boundary c0, random rows (distances far above any
    threshold) of length 0, under C, C, C + 1, C + 2m - 1 (the longest
    one-chunk row), C + 2m and L, and a row with N runs."""
    m = len(unit)
    warm = 2 * m - 1
    c0 = 2 * C if L >= 2 * C + 2 * m else C
    rows, lens = [], []
    for start in (c0 - m, c0, c0 + m)[:n_planted]:
        for src in (unit, revcomp(unit)):
            t = rng.integers(0, 4, L).astype(np.int8)
            copy = _noisy(rng, src, 0.08)[:L - start]
            t[start:start + len(copy)] = copy
            rows.append(t)
            lens.append(L)
    for n in (0, C // 3, C, C + 1, C + warm, C + warm + 1, L):
        rows.append(rng.integers(0, 4, L).astype(np.int8))
        lens.append(min(n, L))
    t = rows[0].copy()                          # N runs inside the copy
    for s in (c0 - m // 3, c0 + 5):
        t[s:s + 7] = 4
    rows.append(t)
    lens.append(L)
    return np.stack(rows), np.array(lens, np.int32)


def _whole_row(unit, codes, lens):
    """The whole rows' HW distances, both strands, by the native DP."""
    return [native_edit_distance_batch(u, codes, lens, mode="HW")[0]
            for u in (unit, revcomp(unit))]


def _peqs(unit, device="cpu"):
    return (words_tensor(build_peq(unit), device),
            words_tensor(build_peq(revcomp(unit)), device))


def _words(unit, device="cpu"):
    return tuple(int32_words(p) for p in _peqs(unit, device))


def _packed(codes, lens, device="cpu"):
    packed, n_mask = pack_2bit(codes, lens)
    return (torch.as_tensor(packed, device=device),
            None if n_mask is None else torch.as_tensor(n_mask,
                                                        device=device))


def test_chunk_windows_plan():
    """Windows own every column once, start at a multiple of CHUNK_ALIGN
    at least 2m - 1 columns before the columns they own, and a row of at
    most C + 2m - 1 columns is one window."""
    for m, C in ((90, 1024), (2055, 4096), (3222, 4096), (2055, 2048)):
        warm = 2 * m - 1
        for n in (0, 1, C - 1, C, C + 1, C + warm, C + warm + 1, SEG,
                  SEG + 3):
            w = chunk_windows(n, m, C)
            if n <= C + warm:
                assert w == [(0, n)]
                continue
            assert len(w) == -(-n // C)
            for q, (s, e) in enumerate(w):
                lo = q * C
                assert e == min(n, lo + C) and s % CHUNK_ALIGN == 0
                assert s == 0 or warm <= lo - s < warm + CHUNK_ALIGN


@pytest.mark.parametrize("m,L,spread,widths", [
    # rows 1, 4, 5, 16, 17, 33, 34, 128 of DXZ1's segments over 132
    # pairs: the least width whose chunks fit, at most two a row
    (2055, SEG, 132, [1024, 1024, 2048, 4096, 8192, 8192, 16384, 16384]),
    (2055, SEG, 1 << 30, [CHUNK_MIN] * 8),
    (3222, SEG, 264, [1024, 1024, 1024, 2048, 4096, 4096, 8192, 16384]),
    (90, 1024, 1, [CHUNK_MIN] * 8),             # a row is one chunk
])
def test_chunk_columns_widens_to_the_spread(m, L, spread, widths):
    assert [chunk_columns(m, L, rows, spread)
            for rows in (1, 4, 5, 16, 17, 33, 34, 128)] == widths


@pytest.mark.parametrize("unit_of,C", [
    (90, CHUNK_MIN),        # a small unit: 32 chunks a row
    ("DXZ1_rc", 4096),      # cenX, m = 2055: 8 chunks
    ("D6Z1", 2048),         # cen6, m = 3222: 16 chunks
])
def test_chunk_minimum_is_the_whole_row_distance(unit_of, C):
    rng = np.random.default_rng(len(str(unit_of)) + (C or 0))
    unit = _unit(unit_of, rng)
    m = len(unit)
    codes, lens = _rows(rng, unit, SEG, C)
    B = len(lens)
    packed, n_mask = _packed(codes, lens)
    dist = [torch.full((B,), m, dtype=torch.int32) for _ in range(2)]
    myers_hw_chunks(*_words(unit), packed, n_mask, torch.as_tensor(lens),
                    torch.arange(B), torch.tensor([B], dtype=torch.int32),
                    *dist, m=m, C=C)
    want_f, want_r = _whole_row(unit, codes, lens)
    np.testing.assert_array_equal(dist[0].numpy(), want_f)
    np.testing.assert_array_equal(dist[1].numpy(), want_r)
    assert (want_f[:6:2] < m // 4).all() and (want_r[1:6:2] < m // 4).all()
    assert (np.minimum(want_f, want_r)[6:-1] > m // 4).all()


def _reference_bundle(peq_f, peq_r, codes, lens, hits, *, m, k_budget):
    """The fused step's bundle with every scored row whole (the port's
    scoring before the chunked scorer, and its CPU path today): the first
    k_budget rows of the pass order through `recruit_distances`."""
    B = hits.shape[0]
    fail = hits < 1
    order = torch.argsort(fail.to(torch.int32), stable=True)
    top = order[:min(k_budget, B)]
    dist_f, dist_r = recruit_distances(peq_f, peq_r, codes[top], lens[top],
                                       m=m)
    ok = ~fail[top]
    df = torch.full((B,), m, dtype=torch.int32, device=hits.device)
    dr = df.clone()
    df[top] = torch.where(ok, dist_f, m)
    dr[top] = torch.where(ok, dist_r, m)
    n_pass = (~fail).sum(dtype=torch.int32).reshape(1)
    return torch.cat([df, dr, hits, n_pass])


def _hits(rng, B, n_pass, scattered):
    """Hit counts with n_pass rows at or above 1: the first rows, or rows
    scattered among failing ones."""
    idx = (rng.choice(B, n_pass, replace=False) if scattered
           else np.arange(n_pass))
    hits = np.zeros(B, np.int32)
    hits[idx] = rng.integers(1, 9, n_pass)
    return torch.as_tensor(hits)


@pytest.mark.parametrize("n_pass,scattered,masked", [
    (0, False, False), (1, True, False), (5, True, False),
    (5, False, True), (8, True, False),
    (10, True, True),       # overflow: more than k_budget pass
])
def test_score_chunked_bundle_equals_whole_rows(n_pass, scattered, masked):
    rng = np.random.default_rng(n_pass)
    unit = _unit(90, rng)
    m = len(unit)
    codes, lens = _rows(rng, unit, 4096, CHUNK_MIN, n_planted=2)
    if not masked:
        codes = codes[:-1]
        lens = lens[:-1]
    B = len(lens)
    packed, n_mask = _packed(codes, lens)
    assert (n_mask is None) != masked
    hits = _hits(rng, B, n_pass, scattered)
    peq_f, peq_r = _peqs(unit)
    k_budget = 8
    got = score_chunked(*_words(unit), packed, n_mask, torch.as_tensor(lens),
                        hits, m=m, min_hits=1, k_budget=k_budget)
    want = _reference_bundle(peq_f, peq_r, torch.as_tensor(codes),
                             torch.as_tensor(lens), hits, m=m,
                             k_budget=k_budget)
    assert got.dtype == torch.int32 and got.shape == (3 * B + 1,)
    assert torch.equal(got, want)


def test_myers_hw_chunks_rejects_bad_arguments():
    rng = np.random.default_rng(3)
    unit = _unit(90, rng)
    codes, lens = _rows(rng, unit, 2048, 1024, n_planted=1)
    packed, _ = _packed(codes[:-1], lens[:-1])
    B = packed.shape[0]
    ok = dict(lens=torch.as_tensor(lens[:-1]), top=torch.arange(B),
              n_pass=torch.tensor([B], dtype=torch.int32),
              dist_f=torch.full((B,), 90, dtype=torch.int32),
              dist_r=torch.full((B,), 90, dtype=torch.int32))
    for key, bad, C in (("lens", ok["lens"].long(), None),
                        ("top", torch.arange(B + 1), None),
                        ("n_pass", torch.tensor([B]), None),
                        ("dist_f", ok["dist_f"][:-1], None),
                        ("lens", ok["lens"], 1000)):
        args = {**ok, key: bad}
        with pytest.raises((TypeError, ValueError)):
            myers_hw_chunks(*_words(unit), packed, None, args["lens"],
                            args["top"], args["n_pass"], args["dist_f"],
                            args["dist_r"], m=90, C=C)


@pytest.mark.gpu
@pytest.mark.parametrize("unit_name", ["DXZ1_rc", "D6Z1"])
def test_chunked_bundle_on_gpu_equals_k1_whole_rows(cuda, unit_name):
    """At the fused step's shape (256 candidate rows of 32,768 columns,
    k_budget 128): n_pass 0, 1, 11, 128 and 200 (overflow), the passing
    rows first or scattered among failing ones, with and without an N
    mask; and the launch is the chunked kernel's, once."""
    rng = np.random.default_rng(7)
    unit = encode(read_seq(f"{DATA_DIR}/{unit_name}.fasta"))
    m = len(unit)
    planted, plens = _rows(rng, unit, SEG, 4096)
    B = 256
    codes = rng.integers(0, 4, (B, SEG)).astype(np.int8)
    lens = rng.integers(SEG // 2, SEG + 1, B).astype(np.int32)
    lens[:8] = SEG
    pick = rng.choice(B, len(plens), replace=False)
    codes[pick], lens[pick] = planted, plens
    peq_f, peq_r = _peqs(unit, cuda)
    words = _words(unit, cuda)
    lens_t = torch.as_tensor(lens, device=cuda)
    for masked in (False, True):
        packed, n_mask = _packed(codes, lens, cuda)
        if masked:
            packed, n_mask = _packed(np.where(np.arange(SEG) % 997 == 5, 4,
                                              codes).astype(np.int8), lens,
                                     cuda)
        full = _unpack_2bit(packed, n_mask) if masked else torch.as_tensor(
            codes, device=cuda)
        for n_pass in (0, 1, 11, 128, 200):
            for scattered in (False, True):
                hits = _hits(rng, B, n_pass, scattered).to(cuda)
                before = myers_hw_chunks.launches
                got = score_chunked(*words, packed, n_mask, lens_t,
                                    hits, m=m, min_hits=1,
                                    k_budget=K_BUDGET)
                assert myers_hw_chunks.launches == before + 1
                want = _reference_bundle(peq_f, peq_r, full, lens_t, hits,
                                         m=m, k_budget=K_BUDGET)
                assert torch.equal(got.cpu(), want.cpu()), (n_pass, masked)
