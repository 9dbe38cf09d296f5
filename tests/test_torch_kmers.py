"""The port's k-mer primitives and seed filter against the JAX package on
the same numpy-seeded inputs, exactly: `pack_kmers`, `lookup_codes`,
`build_seed_table`, `seed_hit_counts` and `seed_hit_counts_bitmap`, and
the counting tables (`count_unique`, `count_read_kmer_stats`,
`merge_count_tables`, `table_to_numpy`), whose int64 keys are split back
into the JAX (hi, lo) words to compare."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroflye_tpu.io import encoding as jenc
from centroflye_tpu.ops import kmers as jkmers
from centroflye_tpu.ops import seed_filter as jseed
from centroflye_tpu.pipeline.simulate import add_read_noise, gen_random_seq

from centroflye_tpu_torch.ops import kmers as tkmers
from centroflye_tpu_torch.ops import seed_filter as tseed
from centroflye_tpu_torch.ops.myers import words_tensor


def _batch(seed, B=12, L=80):
    """Codes with N runs, PAD tails and the edge lens 0, 1, k-1-ish and
    past L."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[1, 10:13] = 4
    codes[2, 0] = 4
    codes[3, L - 1] = 4
    codes[4, 30:] = 4
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0] = L
    lens[5] = 0
    lens[6] = 1
    lens[7] = 14
    lens[8] = L + 5
    return codes, lens


def _np(t):
    return t.numpy().astype(np.uint32) if t.dtype == torch.int64 \
        else t.numpy()


@pytest.mark.parametrize("k", [13, 16, 31])
def test_pack_kmers_matches_jax(k):
    codes, lens = _batch(k)
    got = tkmers.pack_kmers(torch.from_numpy(codes), torch.from_numpy(lens),
                            k=k)
    want = jkmers.pack_kmers(jnp.asarray(codes), jnp.asarray(lens), k=k)
    for g, w, name in zip(got, want, ("hi", "lo", "valid")):
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=name)
    assert got[2].any() and not got[2].all()


@pytest.mark.parametrize("k", [13, 16, 31])
@pytest.mark.parametrize("n", [1, 2, 5, 8, 37])
def test_lookup_codes_matches_jax(k, n):
    """Tables of every size class (powers of two, odd, one entry) and
    queries that hit, miss, fall below and above the table, and the
    SENTINEL."""
    rng = np.random.default_rng(100 * k + n)
    codes, lens = _batch(k + n)
    hi, lo, valid = jkmers.pack_kmers(jnp.asarray(codes), jnp.asarray(lens),
                                      k=k)
    pool = np.unique((np.asarray(hi).astype(np.uint64) << np.uint64(32))
                     | np.asarray(lo).astype(np.uint64))
    pool = pool[pool != np.uint64(0xFFFFFFFFFFFFFFFF)]
    table = np.sort(rng.choice(pool, size=n, replace=False))
    t_hi, t_lo = jenc.split_u64(table)
    edges = np.array([0, 0xFFFFFFFFFFFFFFFF], np.uint64)
    q = np.concatenate([table, table + np.uint64(1), table - np.uint64(1),
                        edges, pool[:20]])
    q_hi, q_lo = jenc.split_u64(q)
    want = jkmers.lookup_codes(jnp.asarray(t_hi), jnp.asarray(t_lo),
                               jnp.asarray(q_hi), jnp.asarray(q_lo))
    got = tkmers.lookup_codes(words_tensor(t_hi, "cpu"),
                              words_tensor(t_lo, "cpu"),
                              words_tensor(q_hi, "cpu"),
                              words_tensor(q_lo, "cpu"))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0][:n].all() and got[1].dtype == torch.int32


@pytest.mark.parametrize("n,want_idx", [(3, 2), (5, 5), (7, 6), (37, 37)])
def test_lookup_codes_last_entry_index_as_jax(n, want_idx):
    """A fault both packages share (ROADMAP Queue 3): the search can step
    past the end, so the last entry is found with index n for some n."""
    t_lo = np.arange(10, 10 + n, dtype=np.uint32)
    t_hi = np.zeros(n, np.uint32)
    want = jkmers.lookup_codes(jnp.asarray(t_hi), jnp.asarray(t_lo),
                               jnp.asarray(t_hi[-1:]), jnp.asarray(t_lo[-1:]))
    got = tkmers.lookup_codes(words_tensor(t_hi, "cpu"),
                              words_tensor(t_lo, "cpu"),
                              words_tensor(t_hi[-1:], "cpu"),
                              words_tensor(t_lo[-1:], "cpu"))
    assert bool(got[0][0]) and bool(want[0][0])
    assert int(got[1][0]) == int(want[1][0]) == want_idx


@pytest.mark.parametrize("k", [11, 13])
def test_build_seed_table_matches_jax(k):
    unit = gen_random_seq(np.random.default_rng(k), 150)
    for a, b in zip(tseed.build_seed_table(unit, k),
                    jseed.build_seed_table(unit, k)):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, b)


def _reads(seed, unit, L=512):
    rng = np.random.default_rng(seed)
    rc = jenc.revcomp_str(unit)
    reads = [add_read_noise(rng, unit * 4, 0.1),
             add_read_noise(rng, rc * 3, 0.05),
             gen_random_seq(rng, 400), "",
             unit[:70] + "NNN" + unit[70:] + unit,
             gen_random_seq(rng, 30) + unit[:40]]
    codes, lens = jenc.encode_batch(reads, max_len=L)
    return codes, np.minimum(lens, L).astype(np.int32)


@pytest.mark.parametrize("k,stride", [(11, 1), (13, 2), (13, 3), (15, 4),
                                      (17, 3)])
def test_seed_hit_counts_match_jax(k, stride):
    """Both filters; k = 17 reads past a k <= 15 bitmap, which reads its
    last word as the JAX gather does."""
    unit = gen_random_seq(np.random.default_rng(7), 160)
    codes, lens = _reads(k, unit)
    bm = jseed.build_seed_bitmap(unit, min(k, 15))
    hi, lo = jseed.build_seed_table(unit, k)
    want_bm = jseed.seed_hit_counts_bitmap(jnp.asarray(bm),
                                           jnp.asarray(codes),
                                           jnp.asarray(lens), k=k,
                                           stride=stride)
    want_tb = jseed.seed_hit_counts(jnp.asarray(hi), jnp.asarray(lo),
                                    jnp.asarray(codes), jnp.asarray(lens),
                                    k=k)
    codes_t, lens_t = torch.from_numpy(codes), torch.from_numpy(lens)
    got_bm = tseed.seed_hit_counts_bitmap(words_tensor(bm, "cpu"), codes_t,
                                          lens_t, k=k, stride=stride)
    got_tb = tseed.seed_hit_counts(words_tensor(hi, "cpu"),
                                   words_tensor(lo, "cpu"), codes_t, lens_t,
                                   k=k)
    assert got_bm.dtype == got_tb.dtype == torch.int32
    np.testing.assert_array_equal(got_bm.numpy(), np.asarray(want_bm))
    np.testing.assert_array_equal(got_tb.numpy(), np.asarray(want_tb))
    assert got_tb[0] > 50 and got_tb[1] > 50 and got_tb[3] == 0


def _keys_and_jax(k, seed, B=16, L=70):
    """The windows of a batch with repeats inside and across rows, as JAX
    (hi, lo) words and as the port's int64 keys."""
    codes, lens = _batch(seed, B, L)
    codes[9] = codes[10]
    codes[11, 35:] = codes[11, :35]
    lens[9] = lens[10] = lens[11] = L
    hi, lo, _ = jkmers.pack_kmers(jnp.asarray(codes), jnp.asarray(lens), k=k)
    th, tl, _ = tkmers.pack_kmers(torch.from_numpy(codes),
                                  torch.from_numpy(lens), k=k)
    return hi, lo, tkmers.join_keys(th, tl)


def _same_table(got_keys, want_hi, want_lo):
    hi, lo = tkmers.split_keys(got_keys)
    np.testing.assert_array_equal(_np(hi), np.asarray(want_hi))
    np.testing.assert_array_equal(_np(lo), np.asarray(want_lo))


def test_keys_round_trip_and_sort_last():
    hi = torch.tensor([0, 5, tkmers.SENTINEL, (1 << 30) - 1, 7])
    lo = torch.tensor([3, tkmers.SENTINEL, tkmers.SENTINEL, 9, 0])
    keys = tkmers.join_keys(hi, lo)
    assert int(keys[2]) == tkmers.KEY_SENTINEL == int(keys.max())
    for a, b in zip(tkmers.split_keys(keys), (hi, lo)):
        assert torch.equal(a, b)
    s, p = tkmers.sort_by_code(keys, torch.arange(5))
    assert s.tolist() == sorted(keys.tolist()) and p.tolist() == [0, 1, 4,
                                                                  3, 2]


@pytest.mark.parametrize("k", [13, 19, 31])
@pytest.mark.parametrize("capacity", [16, 1024, 4096])
def test_count_unique_matches_jax(k, capacity):
    """capacity 16 is below the run count: the table holds the first
    runs and n is the true count."""
    hi, lo, keys = _keys_and_jax(k, k)
    want = jkmers.count_unique(hi, lo, capacity=capacity)
    got = tkmers.count_unique(keys, capacity=capacity)
    _same_table(got[0], want[0], want[1])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[2]))
    assert got[1].dtype == torch.int32
    assert int(got[2]) == int(want[3]) and (int(got[2]) > capacity) \
        == (capacity == 16)


@pytest.mark.parametrize("k", [13, 19, 31])
@pytest.mark.parametrize("capacity", [16, 4096])
def test_count_read_kmer_stats_matches_jax(k, capacity):
    hi, lo, keys = _keys_and_jax(k, 2 * k)
    rid = np.broadcast_to((np.arange(16, dtype=np.int32) % 5)[:, None],
                          hi.shape).copy()
    want = jkmers.count_read_kmer_stats(hi, lo, jnp.asarray(rid),
                                        capacity=capacity)
    got = tkmers.count_read_kmer_stats(keys, torch.from_numpy(rid),
                                       capacity=capacity)
    _same_table(got[0], want[0], want[1])
    for g, w in zip(got[1:3], want[2:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[3]) == int(want[4])
    # in-read repeats seen
    assert capacity == 16 or (np.asarray(want[3]) > 0).any()


@pytest.mark.parametrize("two_d", [False, True])
@pytest.mark.parametrize("capacity", [32, 1024])
def test_merge_count_tables_and_readback_match_jax(two_d, capacity):
    """Two tables with shared keys, 1-D and 2-D counts; capacity 32 is
    below the merged run count. Then table_to_numpy of both."""
    rng = np.random.default_rng(capacity + two_d)
    tabs = []
    for seed in (3, 4):
        hi, lo, keys = _keys_and_jax(19, seed)
        w = jkmers.count_unique(hi, lo, capacity=512)
        g = tkmers.count_unique(keys, capacity=512)
        extra = rng.integers(0, 9, (512, 2)).astype(np.int32)
        if two_d:
            wc = jnp.stack([w[2], jnp.asarray(extra[:, 0])], axis=1)
            gc = torch.stack([g[1], torch.from_numpy(extra[:, 0])], dim=1)
        else:
            wc, gc = w[2], g[1]
        tabs.append(((w[0], w[1], wc), (g[0], gc)))
    (wa, ga), (wb, gb) = tabs
    want = jkmers.merge_count_tables(*wa, *wb, capacity=capacity)
    got = tkmers.merge_count_tables(*ga, *gb, capacity=capacity)
    _same_table(got[0], want[0], want[1])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[2]))
    assert int(got[2]) == int(want[3]) and (int(got[2]) > capacity) \
        == (capacity == 32)
    for g, w in zip(tkmers.table_to_numpy(*got),
                    jkmers.table_to_numpy(*want)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
