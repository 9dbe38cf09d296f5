"""K2 and K3 of the port: the one-strand HW Myers (`myers_hw_v3`) and the
threshold-k banded HW Myers (`myers_hw_v3_banded`). Their plain versions
are held against the JAX Pallas kernels `myers_hw_pallas_v3` and
`myers_hw_pallas_v3_banded` in interpret mode, exactly (every output is
an integer). The CUDA kernels are held against the plain versions in the
`gpu` tests, which skip without a card."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroflye_tpu.ops.myers_pallas_v3 import (myers_hw_pallas_v3,
                                                myers_hw_pallas_v3_banded)

from centroflye_tpu_torch.io.encoding import decode, encode
from centroflye_tpu_torch.ops.myers import build_peq, words_tensor
from centroflye_tpu_torch.ops.myers_cuda import (
    myers_hw_2strand, myers_hw_v3, myers_hw_v3_banded,
    myers_hw_v3_banded_plain, myers_hw_v3_plain, threshold_hw)
from centroflye_tpu_torch.pipeline.simulate import add_read_noise


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(seed, m, L, B, noise=(0.01, 0.3)):
    """(peq, codes (B, L), lens) whose rows straddle a threshold: tandem
    copies of the query with substitution and indel noise (lens = L),
    random bases followed by tandem copies (row m-1 leaves the band and
    comes back), random rows, N runs, and lens 0, m-1 and m/2."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, m).astype(np.int8)
    tandem = decode(q) * (L // m + 2)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    lens = np.full(B, L, np.int32)
    for r in range(B):
        if r % 4 == 0:
            row = encode(add_read_noise(rng, tandem, rng.uniform(*noise)))
        elif r % 4 == 1:
            pre = int(rng.integers(0, max(1, L - m)))
            row = np.concatenate([codes[r, :pre],
                                  encode(add_read_noise(rng, tandem, 0.05))])
        else:
            continue
        codes[r] = row[:L]
    for r in range(3, B, 8):                      # N runs
        s = int(rng.integers(0, max(1, L - 40)))
        codes[r, s:s + 40] = 4
    lens[B - 1] = 0
    lens[B - 2] = min(m - 1, L)
    lens[B - 3] = max(1, m // 2)
    return build_peq(q), codes, lens


def _torch_args(peq, codes, lens, device="cpu"):
    return (words_tensor(peq, device),
            torch.from_numpy(codes.T.copy()).to(device),
            torch.from_numpy(lens).to(device))


def _jax_args(peq, codes, lens):
    return (jnp.asarray(peq), jnp.asarray(codes.T),
            jnp.asarray(lens).reshape(-1, 1))


def _assert_equal(got, want):
    """got: the port's outputs; want: the port's (on any device) or
    JAX's."""
    for key in ("dist", "end"):
        assert got[key].dtype == torch.int32
        w = want[key]
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_array_equal(got[key].cpu().numpy(), w, err_msg=key)


@pytest.mark.parametrize("m", [23, 90, 300])
def test_v3_plain_matches_pallas_interpret(m):
    peq, codes, lens = _case(m, m, 256, 128)
    want = myers_hw_pallas_v3(*_jax_args(peq, codes, lens), m=m,
                              interpret=True)
    got = myers_hw_v3_plain(*_torch_args(peq, codes, lens), m=m)
    _assert_equal(got, want)
    assert (int(got["dist"][-1]), int(got["end"][-1])) == (m, -1)


@pytest.mark.parametrize("m,L,k", [(90, 256, 20), (520, 512, 60)])
def test_v3_banded_plain_matches_pallas_interpret(m, L, k):
    peq, codes, lens = _case(k, m, L, 128, noise=(0.01, 0.2))
    want = myers_hw_pallas_v3_banded(*_jax_args(peq, codes, lens), m=m, k=k,
                                     interpret=True)
    got = myers_hw_v3_banded_plain(*_torch_args(peq, codes, lens), m=m, k=k)
    _assert_equal(got, want)
    in_band = got["dist"] < m
    assert int(in_band.sum()) >= 128 // 3        # both sides of k
    assert int((~in_band).sum()) >= 128 // 3
    assert bool((got["end"][~in_band] == -1).all())


def test_v3_wrappers_on_cpu_are_the_plain_versions():
    m, L, B = 33, 64, 16
    args = _torch_args(*_case(3, m, L, B))
    counts = (myers_hw_v3.launches, myers_hw_v3_banded.launches,
              myers_hw_2strand.launches)
    one = myers_hw_v3(*args, m=m)
    _assert_equal(one, myers_hw_v3_plain(*args, m=m))
    for group in (8, 32):
        _assert_equal(myers_hw_v3(*args, m=m, group=group), one)
    for group in (16, 64):
        with pytest.raises(ValueError, match="group"):
            myers_hw_v3(*args, m=m, group=group)
    for k in (0, 5, m):
        banded = myers_hw_v3_banded(*args, m=m, k=k)
        _assert_equal(banded, threshold_hw(one, m=m, k=k))
    assert (myers_hw_v3.launches, myers_hw_v3_banded.launches,
            myers_hw_2strand.launches) == counts    # no kernel launched
    with pytest.raises(ValueError, match="k=-1"):
        myers_hw_v3_banded(*args, m=m, k=-1)


SHAPES = [(1, 64, 12), (33, 200, 130), (90, 256, 128), (2055, 10240, 128),
          (3200, 3600, 10)]


@pytest.mark.gpu
@pytest.mark.parametrize("group", [None, 8, 32])
@pytest.mark.parametrize("m,L,B", SHAPES + [(2055, 2600, 2048)])
def test_v3_kernel_matches_plain_on_gpu(cuda, m, L, B, group):
    """Every instance (G lanes per row; None: the wrapper's pick, 8 at
    the exact tier's 2048 rows) equals the plain version."""
    args = _torch_args(*_case(m, m, L, B), device=cuda)
    before = myers_hw_v3.launches
    got = myers_hw_v3(*args, m=m, group=group)
    torch.cuda.synchronize()
    assert myers_hw_v3.launches == before + 1
    _assert_equal(got, myers_hw_v3_plain(*args, m=m))
    cpu = myers_hw_v3(*(a.cpu() for a in args), m=m)
    _assert_equal(got, cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("m,L,B", SHAPES)
def test_v3_banded_kernel_matches_plain_on_gpu(cuda, m, L, B):
    args = _torch_args(*_case(m + 1, m, L, B), device=cuda)
    unbanded = myers_hw_v3_plain(*args, m=m)      # banded plain = this, cut
    for k in (0, 20, 350, m):
        before = myers_hw_v3_banded.launches
        got = myers_hw_v3_banded(*args, m=m, k=k)
        torch.cuda.synchronize()
        assert myers_hw_v3_banded.launches == before + 1
        _assert_equal(got, threshold_hw(unbanded, m=m, k=k))
    if m <= 90:
        _assert_equal(myers_hw_v3_banded(*args, m=m, k=20),
                      myers_hw_v3_banded_plain(*(a.cpu() for a in args),
                                               m=m, k=20))


@pytest.mark.gpu
def test_v3_kernels_reject_bad_inputs(cuda):
    peq, text_t, lens = _torch_args(*_case(1, 40, 64, 16), device=cuda)
    for call in (myers_hw_v3, functools.partial(myers_hw_v3_banded, k=10)):
        with pytest.raises(TypeError):
            call(peq, text_t.int(), lens, m=40)
        with pytest.raises(TypeError):
            call(peq.int(), text_t, lens, m=40)
        with pytest.raises(ValueError):
            call(peq, text_t, lens.cpu(), m=40)
        with pytest.raises(ValueError):
            call(peq, text_t.t(), lens, m=40)
        with pytest.raises(ValueError):
            call(peq[:, :1], text_t, lens, m=40)
        with pytest.raises(ValueError):
            call(peq, text_t, lens, m=4097)
    with pytest.raises(ValueError, match="group"):
        myers_hw_v3(peq, text_t, lens, m=40, group=4)
    with pytest.raises(ValueError):
        myers_hw_v3_banded(peq, text_t, lens, m=40, k=-1)
