"""The port's native Myers library (`centroflye_tpu_torch/native`) against
the JAX package's: the same source, and each of the six wrappers equal
on numpy-seeded inputs (NW, SHW and HW distances with and without the
banded early-out, the batch, alignment paths, HW locate, path batches
and pairs). Both libraries are built first, and the tests assert that
both loaded: without its library the JAX package returns None."""

import os

import numpy as np
import pytest

from centroflye_tpu import native as jnative
from centroflye_tpu.pipeline.simulate import add_read_noise

from centroflye_tpu_torch import native as tnative
from centroflye_tpu_torch.io.encoding import decode, encode

MODES = ("NW", "SHW", "HW")


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert jnative.load_native(build=True) is not None, \
        "the JAX package's libcfnative.so did not build"
    assert tnative.load_library() is not None


def _pair(rng, m, n, noise=None):
    """A query of length m and a target of length n: random, or the query
    with noise inside random flanks."""
    q = rng.integers(0, 4, m).astype(np.int8)
    if noise is None:
        return q, rng.integers(0, 4, n).astype(np.int8)
    core = encode(add_read_noise(rng, decode(q), noise))
    left = rng.integers(0, 4, n // 3).astype(np.int8)
    return q, np.concatenate([left, core,
                              rng.integers(0, 4, n // 3).astype(np.int8)])


def test_sources_are_the_jax_packages():
    jdir = os.path.dirname(jnative.__file__)
    tdir = os.path.dirname(tnative.__file__)
    with open(os.path.join(jdir, "myers.cpp"), "rb") as f:
        want = f.read()
    with open(os.path.join(tdir, "myers.cpp"), "rb") as f:
        assert f.read() == want

    def alignment_api(name):
        """The header's alignment declarations: the port's header holds
        only these."""
        with open(name) as f:
            text = f.read()
        text = text[text.index("/* ---- alignment"):]
        return text.split("/* ---- streaming")[0].split(
            "#ifdef __cplusplus\n}")[0]
    assert alignment_api(os.path.join(tdir, "cfnative.h")) == \
        alignment_api(os.path.join(jdir, "cfnative.h"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("noise", [None, 0.1])
def test_edit_distance_equal(mode, noise):
    rng = np.random.default_rng(len(mode) * 7 + (noise is None))
    for _ in range(25):
        m = int(rng.integers(1, 200))
        n = int(rng.integers(1, 400))
        q, t = _pair(rng, m, n, noise)
        for k in (-1, 0, 5, 40, m):
            assert tnative.native_edit_distance(q, t, mode, k) == \
                jnative.native_edit_distance(q, t, mode, k), (m, n, k)


@pytest.mark.parametrize("mode", MODES)
def test_edit_distance_edges_equal(mode):
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, 70).astype(np.int8)
    n_run = np.full(90, 4, np.int8)
    for qq, tt in ((q[:0], q), (q, q[:0]), (q, q), (q, n_run),
                   (n_run[:10], q)):
        for k in (-1, 0, 3, 200):
            assert tnative.native_edit_distance(qq, tt, mode, k) == \
                jnative.native_edit_distance(qq, tt, mode, k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("k", [-1, 12])
def test_edit_distance_batch_equal(mode, k):
    rng = np.random.default_rng(11)
    q = rng.integers(0, 4, 64).astype(np.int8)
    lens = np.array([0, 30, 100, 64, 7, 128], np.int32)
    targets = np.full((len(lens), 128), 4, np.int8)
    for i, n in enumerate(lens):
        targets[i, :n] = _pair(rng, 64, int(n), 0.1)[1][:n]
    got = tnative.native_edit_distance_batch(q, targets, lens, mode, k)
    want = jnative.native_edit_distance_batch(q, targets, lens, mode, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tnative.native_edit_distance_batch(q, targets, lens + 1, mode, k)


@pytest.mark.parametrize("mode", MODES)
def test_align_path_equal(mode):
    rng = np.random.default_rng(23)
    for _ in range(20):
        q, t = _pair(rng, int(rng.integers(1, 300)),
                     int(rng.integers(1, 600)), 0.12)
        got = tnative.native_align_path(q, t, mode)
        assert got == jnative.native_align_path(q, t, mode)
        assert got is not None
    assert tnative.native_align_path(q[:0], t, mode) is None
    assert jnative.native_align_path(q[:0], t, mode) is None


def test_hw_locate_equal():
    rng = np.random.default_rng(5)
    for _ in range(10):
        q, t = _pair(rng, 150, 900, 0.08)
        got = tnative.native_hw_locate(decode(q), decode(t))
        assert got == jnative.native_hw_locate(decode(q), decode(t))
        assert 0 <= got[1] <= got[2] <= len(t)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("threads", [1, 3])
def test_align_path_batch_equal(mode, threads):
    rng = np.random.default_rng(29)
    t = rng.integers(0, 4, 500).astype(np.int8)
    queries = [encode(add_read_noise(rng, decode(t[s:s + n]), 0.1))
               for s, n in ((0, 120), (40, 300), (300, 200), (10, 1))]
    queries.append(rng.integers(0, 4, 80).astype(np.int8))
    got = tnative.native_align_path_batch(queries, t, mode, threads)
    assert got == jnative.native_align_path_batch(queries, t, mode, threads)
    assert len(got) == len(queries) and all(g[0] >= 0 for g in got)
    assert tnative.native_align_path_batch([], t, mode) == []


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("threads", [1, 4])
def test_align_path_pairs_equal(mode, threads):
    rng = np.random.default_rng(31)
    pairs = [_pair(rng, int(rng.integers(1, 250)),
                   int(rng.integers(1, 500)), 0.1) for _ in range(9)]
    queries, targets = [p[0] for p in pairs], [p[1] for p in pairs]
    got = tnative.native_align_path_pairs(queries, targets, mode, threads)
    assert got == jnative.native_align_path_pairs(queries, targets, mode,
                                                  threads)
    assert all(g[0] >= 0 for g in got)
    assert tnative.native_align_path_pairs([], [], mode) == []
    with pytest.raises(ValueError):
        tnative.native_align_path_pairs(queries, targets[1:], mode)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler error raises, with no library left behind; so does a
    missing g++. Nothing falls back."""
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tnative, "CXX_FLAGS",
                        tnative.CXX_FLAGS + ["-fno-such-flag-anywhere"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build()
    assert os.listdir(tmp_path) == []
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.build()
