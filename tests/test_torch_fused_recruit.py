"""The port's fused recruitment step against JAX `make_fused_recruit` on
the same packed batches: the bundled [df | dr | hits | n_pass] output is
equal, element for element, with and without survivor overflow, on the
packed path, the N-masked path and the unpacked filter path."""

import numpy as np
import pytest
import torch

from centroflye_tpu.io import encoding as jenc
from centroflye_tpu.ops import fused_recruit as jfused
from centroflye_tpu.ops.myers import build_peq
from centroflye_tpu.ops.seed_filter import build_seed_bitmap
from centroflye_tpu.pipeline.simulate import add_read_noise, gen_random_seq

from centroflye_tpu_torch.ops import fused_recruit as tfused
from centroflye_tpu_torch.ops.myers import int32_words, words_tensor
from centroflye_tpu_torch.ops.myers_cuda import myers_hw_chunks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _batch(seed, B, L, n_tandem, with_n=False):
    """Packed candidate batch: tandem rows on both strands, rows with a
    short unit fragment (some pass the sampled filter, some fail),
    random rows, a zero-length row and short rows; with_n puts N runs in
    range on every fifth row (tandem rows included) and returns the
    mask."""
    rng = np.random.default_rng(seed)
    unit = gen_random_seq(rng, 120)
    rc = jenc.revcomp_str(unit)
    seqs = []
    for r in range(B):
        if r < n_tandem:
            src = unit if r % 2 == 0 else rc
            s = add_read_noise(rng, src * (L // 120 + 2), 0.05)
        elif r % 3 == 0:
            frag = int(rng.integers(20, 110))
            s = gen_random_seq(rng, 60) + unit[:frag] + gen_random_seq(rng, L)
        else:
            s = gen_random_seq(rng, L)
        seqs.append(s[:L])
    codes, lens = jenc.encode_batch(seqs, max_len=L)
    lens = np.minimum(lens, rng.integers(L // 2, L + 1, B)).astype(np.int32)
    lens[B - 1] = 0
    lens[B - 2] = 17
    if with_n:
        for r in range(0, B, 5):
            s = int(rng.integers(0, max(1, lens[r] - 6)))
            codes[r, s:s + 6] = 4
    packed, n_mask = jfused.pack_2bit(codes, lens)
    assert (n_mask is None) != with_n
    if with_n:
        return unit, packed, n_mask, lens
    return unit, packed, lens


def _pair(unit, k_budget, stride, device="cpu", seed_k=13, packed=True):
    """(JAX, port) fused steps over the same tables; packed=False gives
    both no LE bitmap, so the no-mask batches take the unpacked path."""
    uc = jenc.encode(unit)
    pf, pr = build_peq(uc), build_peq(jenc.revcomp(uc))
    bm = build_seed_bitmap(unit, 13)
    bm_le = build_seed_bitmap(unit, 13, le=True) if packed else None
    jax_fused = jfused.make_fused_recruit(
        bm, pf, pr, m=len(unit), seed_k=seed_k, min_hits=8,
        k_budget=k_budget, stride=stride, use_pallas=False, mesh=None,
        seed_bitmap_le=bm_le)
    port_fused = tfused.make_fused_recruit(
        words_tensor(bm, device), words_tensor(pf, device),
        words_tensor(pr, device), m=len(unit), seed_k=seed_k, min_hits=8,
        k_budget=k_budget, stride=stride,
        seed_bitmap_le=None if bm_le is None else words_tensor(bm_le,
                                                               device))
    return jax_fused, port_fused


@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("B,n_tandem,k_budget", [
    (64, 12, 128),      # every passing row scored
    (32, 12, 8),        # overflow: n_pass > k_budget
    (256, 150, 128),    # overflow at the engine's budget
])
def test_fused_bundle_matches_jax(B, n_tandem, k_budget, stride):
    unit, packed, lens = _batch(B + stride, B, 320, n_tandem)
    jax_fused, port_fused = _pair(unit, k_budget, stride)
    want = np.asarray(jax_fused.raw(packed, None, lens))
    got = port_fused.raw(packed, None, lens)
    assert got.dtype == torch.int32 and got.shape == (3 * B + 1,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_fused.min_hits == jax_fused.min_hits
    assert port_fused.stride == jax_fused.stride
    df, dr, hits, n_pass = port_fused(packed, None, lens)
    jdf, jdr, jhits, jn = jax_fused.unbundle(want, B)
    assert n_pass == jn and n_pass >= min(n_tandem, k_budget)
    for a, b in ((df, jdf), (dr, jdr), (hits, jhits)):
        np.testing.assert_array_equal(a, b)
    assert (np.minimum(df, dr)[:min(n_tandem, k_budget)] < 40).all()


def test_fused_rejects_n_mask():
    """An N mask, once rejected, now takes the masked path: the bundle
    equals JAX's, and N bases match nothing. A mask of the wrong shape is
    rejected."""
    unit, packed, n_mask, lens = _batch(1, 40, 320, 12, with_n=True)
    jax_fused, port_fused = _pair(unit, 128, 2)
    want = np.asarray(jax_fused.raw(packed, n_mask, lens))
    got = port_fused.raw(packed, n_mask, lens)
    np.testing.assert_array_equal(got.numpy(), want)
    masked = port_fused(packed, n_mask, lens)
    unmasked = port_fused(packed, None, lens)     # N read as base A
    assert not np.array_equal(masked[2], unmasked[2])
    with pytest.raises(RuntimeError):
        port_fused.raw(packed, n_mask[:, :-1], lens)


@pytest.mark.parametrize("B,n_tandem,k_budget", [(64, 12, 128),
                                                 (256, 150, 128)])
def test_fused_masked_bundle_matches_jax(B, n_tandem, k_budget):
    unit, packed, n_mask, lens = _batch(B + 3, B, 320, n_tandem, with_n=True)
    jax_fused, port_fused = _pair(unit, k_budget, 2)
    want = np.asarray(jax_fused.raw(packed, n_mask, lens))
    got = port_fused.raw(packed, n_mask, lens)
    assert got.dtype == torch.int32 and got.shape == (3 * B + 1,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed_k,stride,packed", [
    (17, 2, True),      # k > 16: no packed filter even with an LE bitmap
    (13, 3, True),      # stride outside (1, 2, 4)
    (13, 2, False),     # no LE bitmap
    (17, 3, True),
])
def test_fused_unpacked_filter_path_matches_jax(seed_k, stride, packed):
    unit, packed_rows, lens = _batch(seed_k + stride, 64, 320, 12)
    jax_fused, port_fused = _pair(unit, 32, stride, seed_k=seed_k,
                                  packed=packed)
    want = np.asarray(jax_fused.raw(packed_rows, None, lens))
    got = port_fused.raw(packed_rows, None, lens)
    np.testing.assert_array_equal(got.numpy(), want)
    assert port_fused.min_hits == jax_fused.min_hits


@pytest.mark.gpu
def test_fused_bundle_on_gpu_matches_cpu(cuda):
    unit, packed, lens = _batch(9, 256, 1024, 150)
    _, cpu_fused = _pair(unit, 128, 2)
    _, gpu_fused = _pair(unit, 128, 2, cuda)
    before = myers_hw_chunks.launches
    got = gpu_fused.raw(packed, None, lens).cpu()
    assert myers_hw_chunks.launches == before + 1
    assert torch.equal(got, cpu_fused.raw(packed, None, lens))


@pytest.mark.gpu
def test_fused_masked_bundle_on_gpu_matches_cpu(cuda):
    unit, packed, n_mask, lens = _batch(11, 256, 1024, 150, with_n=True)
    _, cpu_fused = _pair(unit, 128, 2)
    _, gpu_fused = _pair(unit, 128, 2, cuda)
    before = myers_hw_chunks.launches
    got = gpu_fused.raw(packed, n_mask, lens).cpu()
    assert myers_hw_chunks.launches == before + 1
    assert torch.equal(got, cpu_fused.raw(packed, n_mask, lens))


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_packed_hits_plain_matches_jax_at_boundary_lengths(stride):
    """The plain packed filter (the kernel's plain version) counts the
    JAX package's hits on rows of length 0, shorter than the seed, and at
    16w + o + seed_k - 1, + 0 and + 1 for every in-word phase o, on tandem
    rows (where the boundary window hits) and random rows."""
    B, L, k = 128, 1024, 13
    unit, packed, lens = _batch(40 + stride, B, L, 64)
    nw = L // 16
    edge = [16 * ((3 + 5 * o) % (nw - 1)) + o + k + d
            for o in range(16) for d in (-1, 0, 1)]
    lens[:48] = edge                    # tandem rows
    lens[64:112] = edge                 # random and fragment rows
    lens[112:116] = (0, 5, k - 1, k)
    jax_fused, _ = _pair(unit, 128, stride)
    want = np.asarray(jax_fused.raw(packed, None, lens))[2 * B:3 * B]
    bm = words_tensor(build_seed_bitmap(unit, 13, le=True), "cpu")
    got = tfused.packed_hits_plain(int32_words(bm), torch.from_numpy(packed),
                                   torch.from_numpy(lens), seed_k=k,
                                   stride=stride)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:48] > 0).all() and (want[112:116] == 0).all()
