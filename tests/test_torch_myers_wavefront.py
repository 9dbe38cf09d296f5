"""The wavefront schedule of `csrc/myers_hw_2strand.cu` (kernels K1 and
K2), transliterated lane by lane into numpy and held exactly against the
plain version `myers_hw_v3_plain`, and at m = 90 against the JAX Pallas
kernel in interpret mode.

The transliteration follows the kernel's step loop: groups of G lanes,
WPL word slots a lane with the pad bits below row 0 (row m-1 is bit 31 of
the tap lane's last slot), the shared-memory Eq table laid out by slot,
one packed word (carry, hp and hn tops, the Eq row of the next column)
handed to lane l+1 per step, lane 0's text codes fetched kUnroll columns
ahead, the tap lane's score, and 32/G groups of ragged lengths sharing a
warp, which runs to the largest bound among them. The CUDA kernel itself
runs only on a card (`gpu` tests)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroflye_tpu.ops.myers_pallas_v3 import myers_hw_pallas_v3_2strand

from centroflye_tpu_torch.io.encoding import revcomp
from centroflye_tpu_torch.ops.myers import build_peq, n_words, words_tensor
from centroflye_tpu_torch.ops.myers_cuda import (GROUPS, MAX_WORDS,
                                                 myers_hw_v3_plain,
                                                 pick_group)

THREADS = 64          # the kernel's block
UNROLL = 4            # the kernel's steps per text prefetch
FULL = np.uint32(0xFFFFFFFF)


def wavefront(peqs, text_t, lens, m, G):
    """Lane-by-lane numpy model of the kernel with STRANDS = len(peqs).
    peqs: list of (5, W) uint32; text_t: (L, B) int8; lens: (B,) ->
    per strand (dist, end), each (B,) int32."""
    strands = len(peqs)
    L, B = text_t.shape
    W = n_words(m)
    wpl = -(-W // G)
    S = G * wpl
    row_bytes = 4 * S                          # one code's Eq row
    used = -(-W // wpl)                        # lanes holding words
    pad = used * wpl * 32 - m                  # neutral bits below row 0
    tap_lane = used - 1
    assert used <= G and 5 * row_bytes <= 0x3FFFFFFC

    # Eq table by slot: query row r at bit r + pad of the group's slots
    table = np.zeros((strands, 5, S), np.uint32)
    for s, peq in enumerate(peqs):
        bits = np.zeros((4, S * 32), np.uint8)
        bits[:, pad:pad + m] = np.unpackbits(peq[:4].astype("<u4").view(np.uint8),
                                      axis=1, bitorder="little")[:, :m]
        table[s, :4] = np.packbits(bits, axis=1, bitorder="little").view(
            "<u4")

    # every problem of every launched block: (row, strand), rows >= B idle
    n_prob = -(-B * strands * G // THREADS) * THREADS // G
    prob = np.arange(n_prob)
    row, strand = prob // strands, prob % strands
    live = row < B
    n = np.where(live, np.clip(lens[np.minimum(row, B - 1)], 0, L), 0)
    warp = prob // (32 // G)
    n_warp = np.zeros(warp.max() + 1, np.int64)
    np.maximum.at(n_warp, warp, n)
    bound = np.where(n_warp > 0, n_warp + tap_lane + 1, 0)
    steps = (-(-bound // UNROLL) * UNROLL)[warp]   # whole prefetch blocks

    def code_row(j):
        """Lane 0's Eq row offset of column j per problem: N past the row."""
        ok = j < n
        c = np.full(n_prob, 4, np.uint32)
        if ok.any():
            c[ok] = text_t[j, row[ok]].astype(np.uint8)
        return np.minimum(c, 4).astype(np.uint32) * row_bytes

    slot = np.arange(G)[:, None] * wpl + np.arange(wpl)[None, :]  # (G, WPL)
    vp = np.full((n_prob, G, wpl), FULL, np.uint32)
    vn = np.zeros((n_prob, G, wpl), np.uint32)
    eq = np.zeros((n_prob, G, wpl), np.uint32)
    # packet: hp top bit 31, hn top bit 30, next column's Eq row, carry bit 0
    pkt = np.full((n_prob, G), 4 * row_bytes, np.uint32)
    pkt[:, 0] = code_row(0)
    score = np.full(n_prob, m, np.int64)
    best = score.copy()
    best_s = np.zeros(n_prob, np.int64)

    for s in range(int(steps.max(initial=0))):
        run = s < steps                        # the problem's warp still loops
        next_row = pkt & np.uint32(0x3FFFFFFC)
        eq_next = table[strand[:, None, None],
                        (next_row // row_bytes)[:, :, None], slot[None]]
        carry = pkt & 1
        hp_lo, hn_lo = pkt, pkt << 1           # bit 31: the tops from below
        new_vp, new_vn = vp.copy(), vn.copy()
        for i in range(wpl):
            x, v, e = vp[:, :, i], vn[:, :, i], eq[:, :, i]
            total = (e & x).astype(np.uint64) + x + carry
            carry = (total >> 32).astype(np.uint32)
            d0 = (total.astype(np.uint32) ^ x) | e | v
            hp = v | ~(d0 | x)
            hn = x & d0
            hps = (hp << 1) | (hp_lo >> 31)    # __funnelshift_l(lo, hi, 1)
            hns = (hn << 1) | (hn_lo >> 31)
            hp_lo, hn_lo = hp, hn
            new_vp[:, :, i] = hns | ~(d0 | hps)
            new_vn[:, :, i] = hps & d0
        out = ((hp & np.uint32(0x80000000)) | ((hn >> 1) & np.uint32(0x40000000))
               | next_row | carry)
        shifted = np.concatenate([out[:, :1], out[:, :-1]], axis=1)
        shifted[:, 0] = code_row(s + 1)        # HW: nothing enters row 0

        tap_hp, tap_hn = hp[:, tap_lane] >> 31, hn[:, tap_lane] >> 31
        score = np.where(run, score + tap_hp.astype(np.int64) - tap_hn, score)
        better = run & (score < best)
        best = np.where(better, score, best)
        best_s = np.where(better, s, best_s)
        keep = run[:, None, None]
        vp = np.where(keep, new_vp, vp)
        vn = np.where(keep, new_vn, vn)
        eq = np.where(keep, eq_next, eq)
        pkt = np.where(run[:, None], shifted, pkt)

    end = np.where(best < m, best_s - 1 - tap_lane, -1)
    return [(best[live & (strand == s)].astype(np.int32),
             end[live & (strand == s)].astype(np.int32))
            for s in range(strands)]


def _case(seed, m, L, B):
    """Ragged two-strand batch: tandem rows of the query and its reverse
    complement (exact and 8% noisy), N runs, an all-N row, lens 0, m-1,
    m/2 and random, random rows."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, m).astype(np.int8)
    qr = revcomp(q)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    reps = L // m + 2
    codes[0] = np.tile(q, reps)[:L]
    codes[1] = np.tile(qr, reps)[:L]
    for r in range(2, B, 5):
        row = np.tile(q if r % 2 else qr, reps)[:L].copy()
        flip = rng.random(L) < 0.08
        row[flip] = rng.integers(0, 4, int(flip.sum()))
        codes[r] = row
    for r in range(3, B, 4):
        s = int(rng.integers(0, max(1, L - 20)))
        codes[r, s:s + 20] = 4
    codes[4] = 4
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:3] = L
    lens[5] = 0
    lens[6] = min(L, max(1, m - 1))
    lens[7] = min(L, max(1, m // 2))
    return build_peq(q), build_peq(qr), codes, lens


def _plain(peq, codes, lens, m):
    out = myers_hw_v3_plain(words_tensor(peq, "cpu"),
                            torch.from_numpy(codes.T.copy()),
                            torch.from_numpy(lens), m=m)
    return out["dist"].numpy(), out["end"].numpy()


# m = 32, 256 (G = 8), 2048 and 4096 fill their lanes' slots: no pad bits
CASES = [(1, 40, 11), (32, 100, 12), (33, 120, 13), (64, 200, 10),
         (90, 256, 12), (256, 600, 10), (300, 700, 10), (2048, 2200, 9),
         (2055, 2300, 9), (3200, 3400, 9), (4096, 4200, 9)]


@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("m,L,B", CASES)
def test_wavefront_equals_plain(m, L, B, G):
    pf, pr, codes, lens = _case(m + G, m, L, B)
    got = wavefront([pf, pr], codes.T.copy(), lens, m, G)
    for (dist, end), peq in zip(got, (pf, pr)):
        want_d, want_e = _plain(peq, codes, lens, m)
        np.testing.assert_array_equal(dist, want_d)
        np.testing.assert_array_equal(end, want_e)
    assert int(got[0][0][0]) == 0 and int(got[1][0][1]) == 0   # tandem rows
    assert (int(got[0][0][5]), int(got[0][1][5])) == (m, -1)   # lens 0


@pytest.mark.parametrize("G", GROUPS)
def test_wavefront_one_strand_equals_plain(G):
    """STRANDS = 1 (K2): one problem a row, 32/G rows a warp."""
    m, L, B = 300, 650, 11
    pf, _, codes, lens = _case(7 * G, m, L, B)
    (dist, end), = wavefront([pf], codes.T.copy(), lens, m, G)
    want_d, want_e = _plain(pf, codes, lens, m)
    np.testing.assert_array_equal(dist, want_d)
    np.testing.assert_array_equal(end, want_e)


@pytest.mark.parametrize("G", GROUPS)
def test_wavefront_equals_pallas_interpret(G):
    m, L, B = 90, 256, 128
    pf, pr, codes, lens = _case(11, m, L, B)
    want = myers_hw_pallas_v3_2strand(
        jnp.asarray(pf), jnp.asarray(pr), jnp.asarray(codes.T),
        jnp.asarray(lens).reshape(-1, 1), m=m, interpret=True)
    got = wavefront([pf, pr], codes.T.copy(), lens, m, G)
    for (dist, end), s in zip(got, "fr"):
        np.testing.assert_array_equal(dist, np.asarray(want[f"dist_{s}"]))
        np.testing.assert_array_equal(end, np.asarray(want[f"end_{s}"]))


def test_every_instance_fits_the_range():
    """Every m in 1..4096 has an instance at every G, with its tap lane
    inside the group; the wrapper's rule picks 32 for the fused step's
    128 rows and 8 for the exact tier's 2048, switching above 512
    (row, strand) problems."""
    for G in GROUPS:
        for W in range(1, MAX_WORDS + 1):
            wpl = -(-W // G)
            assert 1 <= wpl <= MAX_WORDS // G
            assert -(-W // wpl) <= G
    assert pick_group(128, 2) == 32 and pick_group(2048, 2) == 8
    assert (pick_group(256, 2), pick_group(257, 2)) == (32, 8)
    assert (pick_group(512, 1), pick_group(513, 1)) == (32, 8)
