"""The port's host (numpy) helpers equal the JAX package's, bit for bit:
encodings, peq tables, seed bitmaps, the host prescan, 2-bit packing and
the read simulator. Exact comparisons: every output is an integer or a
string."""

import numpy as np
import pytest

from centroflye_tpu.io import encoding as jenc
from centroflye_tpu.ops import fused_recruit as jfused
from centroflye_tpu.ops import myers as jmyers
from centroflye_tpu.ops import seed_filter as jseed
from centroflye_tpu.pipeline import simulate as jsim

from centroflye_tpu_torch.io import encoding as tenc
from centroflye_tpu_torch.ops import fused_recruit as tfused
from centroflye_tpu_torch.ops import myers as tmyers
from centroflye_tpu_torch.ops import seed_filter as tseed
from centroflye_tpu_torch.pipeline import simulate as tsim

SEQS = ["", "A", "ACGT", "acgtNNxyz-ACGT", "N" * 17,
        "".join("ACGT"[i] for i in np.random.default_rng(3).integers(
            0, 4, 301))]


@pytest.mark.parametrize("seq", SEQS)
def test_encode_decode_revcomp(seq):
    codes = tenc.encode(seq)
    np.testing.assert_array_equal(codes, jenc.encode(seq))
    assert codes.dtype == np.int8
    assert tenc.decode(codes) == jenc.decode(codes)
    np.testing.assert_array_equal(tenc.revcomp(codes), jenc.revcomp(codes))
    assert tenc.revcomp_str(seq) == jenc.revcomp_str(seq)


def test_encode_batch():
    for max_len in (None, 5, 400):
        t = tenc.encode_batch(SEQS, max_len=max_len)
        j = jenc.encode_batch(SEQS, max_len=max_len)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [1, 5, 13, 15])
@pytest.mark.parametrize("seq", SEQS[2:])
def test_kmer_codes(seq, k):
    c = tenc.encode(seq)
    for got, want in zip(tenc.kmer_codes(c, k), jenc.kmer_codes(c, k)):
        np.testing.assert_array_equal(got, want)
    codes, _ = jenc.kmer_codes(c, k)
    for got, want in zip(tenc.split_u64(codes), jenc.split_u64(codes)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [1, 31, 32, 33, 90, 2055])
def test_build_peq(m):
    q = np.random.default_rng(m).integers(0, 5, m).astype(np.int8)
    np.testing.assert_array_equal(tmyers.build_peq(q), jmyers.build_peq(q))
    np.testing.assert_array_equal(tmyers.build_peq(q, m + 40),
                                  jmyers.build_peq(q, m + 40))
    words = tmyers.words_tensor(tmyers.build_peq(q), "cpu")
    np.testing.assert_array_equal(words.numpy().astype(np.uint32),
                                  jmyers.build_peq(q))


@pytest.mark.parametrize("le", [False, True])
@pytest.mark.parametrize("k", [7, 13])
def test_build_seed_bitmap(k, le):
    unit = jsim.gen_random_seq(np.random.default_rng(k), 250)
    np.testing.assert_array_equal(tseed.build_seed_bitmap(unit, k, le=le),
                                  jseed.build_seed_bitmap(unit, k, le=le))


def _packed_batch(seed, B=24, L=256, with_n=False):
    rng = np.random.default_rng(seed)
    unit = jsim.gen_random_seq(rng, 200)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    for r in range(0, B, 3):           # unit copies: prescan hits
        codes[r, 10:210] = jenc.encode(unit)
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0] = L
    if with_n:
        codes[1, 5:9] = 4
        codes[2, L - 3:] = 4           # N past the row's length only
        lens[2] = L - 3
    return unit, codes, lens


@pytest.mark.parametrize("with_n", [False, True])
@pytest.mark.parametrize("use_lens", [False, True])
def test_pack_2bit_and_unpack(with_n, use_lens):
    _, codes, lens = _packed_batch(5, with_n=with_n)
    lens_arg = lens if use_lens else None
    tp, tm = tfused.pack_2bit(codes, lens_arg)
    jp, jm = jfused.pack_2bit(codes, lens_arg)
    np.testing.assert_array_equal(tp, jp)
    assert (tm is None) == (jm is None)
    if tm is not None:
        np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tfused.unpack_2bit_host(tp),
                                  jfused.unpack_2bit_host(jp))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_prescan_hits(seed):
    unit, codes, lens = _packed_batch(seed)
    packed, _ = jfused.pack_2bit(codes, lens)
    bm = jseed.build_seed_bitmap(unit, 13, le=True)
    got = tseed.host_prescan_hits(packed, lens, bm, k=13)
    np.testing.assert_array_equal(
        got, jseed.host_prescan_hits(packed, lens, bm, k=13))
    assert got[0] > 0


@pytest.mark.parametrize("rate", [0.0, 0.05, 0.10])
def test_simulator_same_stream(rate):
    tr, jr = np.random.default_rng(11), np.random.default_rng(11)
    for n in (0, 1, 500):
        assert tsim.gen_random_seq(tr, n) == jsim.gen_random_seq(jr, n)
    unit = tsim.gen_random_seq(tr, 300)
    assert unit == jsim.gen_random_seq(jr, 300)
    for _ in range(3):
        assert tsim.add_read_noise(tr, unit * 3, rate) == \
            jsim.add_read_noise(jr, unit * 3, rate)
    # both generators were advanced identically
    assert tr.integers(0, 1 << 30) == jr.integers(0, 1 << 30)
