"""The fused step's packed seed filter and compaction
(`ops/fused_recruit.seed_filter_compact`, `csrc/seed_filter.cu`). On the
CPU: the wrapper's argument checks, and the counter of the steps whose
filter it ran. On the card (`gpu`): the kernel's bundle and pass order
equal the plain version's bit for bit at the fused step's shape (256 and
64 rows of 32,768 columns), with n_pass 0, 1, 11, 128 and 200, passing
rows first or scattered, strides 1, 2 and 4, DXZ1 and D6Z1, rows of
length 0, shorter than the seed and at every phase's boundary; the fused
step's df and dr after K1c equal K1's on the pass order's rows whole;
and a packed fused step is the two launches, the filter's and K1c's."""

import numpy as np
import pytest
import torch

from centroflye_tpu_torch import DATA_DIR
from centroflye_tpu_torch.io.encoding import encode, revcomp
from centroflye_tpu_torch.io.fasta import read_seq
from centroflye_tpu_torch.ops import fused_recruit as fr
from centroflye_tpu_torch.ops.myers import (build_peq, int32_words,
                                            words_tensor)
from centroflye_tpu_torch.ops.myers_cuda import (myers_hw_chunks,
                                                 recruit_distances)
from centroflye_tpu_torch.ops.seed_filter import build_seed_bitmap
from centroflye_tpu_torch.utils.logging_utils import recording

SEG = 32768         # the fused step's rows (recruit_file's segment length)
SEED_K = 13
K_BUDGET = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _unit(name):
    return encode(read_seq(f"{DATA_DIR}/{name}.fasta"))


def _bitmap_words(unit_codes, device="cpu"):
    seq = "".join("ACGT"[c] for c in unit_codes)
    return int32_words(words_tensor(build_seed_bitmap(seq, SEED_K, le=True),
                                    device))


def boundary_lens(seed_k, nw):
    """Lengths 16w + o + seed_k - 1, + 0 and + 1 for every in-word phase
    o, at words w spread over the row: the window (w, o) counts from the
    middle one on."""
    return [16 * ((100 + 97 * o) % (nw - 1)) + o + seed_k + d
            for o in range(16) for d in (-1, 0, 1)]


class Pools:
    """B tandem rows (the unit or its reverse complement, 3% substitutions)
    that pass the sampled filter and B random rows that fail it, with
    their lengths: boundary lengths in both, rel2-like lengths (lognormal,
    median 10 kb) in the rest, and 0, 5, seed_k - 1, seed_k and seed_k + 1
    among the random rows. A case takes each row from one pool."""

    def __init__(self, rng, unit, B, stride, bitmap):
        self.min_hits = max(1, 8 // stride)
        nw = SEG // 16
        rel2 = np.clip(rng.lognormal(np.log(10_000), 0.9, B), 500,
                       SEG).astype(np.int32)
        edge = boundary_lens(SEED_K, nw)
        t_lens = rel2.copy()
        t_lens[:len(edge)] = edge
        r_lens = rel2[::-1].copy()
        r_lens[8:8 + len(edge)] = edge
        r_lens[:5] = (0, 5, SEED_K - 1, SEED_K, SEED_K + 1)
        reps = SEG // len(unit) + 1
        tandem = np.empty((B, SEG), np.int8)
        for r in range(B):
            row = np.tile(unit if r % 2 else revcomp(unit), reps)[:SEG].copy()
            flip = rng.random(SEG) < 0.03
            row[flip] = rng.integers(0, 4, int(flip.sum()))
            tandem[r] = row
        rand = rng.integers(0, 4, (B, SEG)).astype(np.int8)
        self.t_packed, self.t_lens = _pack(tandem, t_lens), t_lens
        self.r_packed, self.r_lens = _pack(rand, r_lens), r_lens
        # random rows that pass by chance are drawn again
        for _ in range(20):
            hits = self._hits(bitmap, self.r_packed, self.r_lens, stride)
            bad = np.nonzero(hits >= self.min_hits)[0]
            if not bad.size:
                break
            self.r_packed[bad] = _pack(rng.integers(
                0, 4, (bad.size, SEG)).astype(np.int8), r_lens[bad])
        assert (self._hits(bitmap, self.r_packed, self.r_lens, stride)
                < self.min_hits).all()
        assert (self._hits(bitmap, self.t_packed, self.t_lens, stride)
                >= self.min_hits).all()

    @staticmethod
    def _hits(bitmap, packed, lens, stride):
        return fr.packed_hits_plain(bitmap, torch.from_numpy(packed),
                                    torch.from_numpy(lens), seed_k=SEED_K,
                                    stride=stride).numpy()

    def case(self, rng, B, n_pass, scattered):
        """(packed, lens) of the pools' first B rows with n_pass rows from
        the tandem pool: the first n_pass rows, or n_pass rows drawn at
        random."""
        rows = (rng.choice(B, n_pass, replace=False) if scattered
                else np.arange(n_pass))
        take = np.zeros(B, bool)
        take[rows] = True
        packed = np.where(take[:, None], self.t_packed[:B], self.r_packed[:B])
        lens = np.where(take, self.t_lens[:B], self.r_lens[:B])
        return packed, lens.astype(np.int32)


def _pack(codes, lens):
    packed, n_mask = fr.pack_2bit(codes, lens)
    assert n_mask is None
    return packed


def _kw(m, stride):
    return dict(m=m, seed_k=SEED_K, stride=stride,
                min_hits=max(1, 8 // stride), k_budget=K_BUDGET)


def _fused(unit, stride, device):
    seq = "".join("ACGT"[c] for c in unit)
    return fr.make_fused_recruit(
        words_tensor(build_seed_bitmap(seq, SEED_K), device),
        words_tensor(build_peq(unit), device),
        words_tensor(build_peq(revcomp(unit)), device), m=len(unit),
        seed_k=SEED_K, min_hits=8, k_budget=K_BUDGET, stride=stride,
        seed_bitmap_le=words_tensor(build_seed_bitmap(seq, SEED_K, le=True),
                                    device))


def _small_batch(rng, unit, B=16, L=512):
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    codes[:4] = np.tile(unit, L // len(unit) + 1)[:L]
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:4] = L
    return codes, lens


def test_seed_filter_compact_rejects_bad_arguments():
    """The wrong dtype, shape or device, Lq % 4 != 0, non-contiguous rows,
    and settings the kernel does not take, raise before any launch."""
    rng = np.random.default_rng(5)
    unit = rng.integers(0, 4, 90).astype(np.int8)
    codes, lens = _small_batch(rng, unit)
    packed = torch.from_numpy(_pack(codes, lens))
    lens = torch.from_numpy(lens)
    bm = _bitmap_words(unit)
    kw = _kw(90, 2)
    fr.seed_filter_compact(bm, packed, lens, **kw)          # the good call
    meta = torch.device("meta")
    for args, extra in (
            ((bm, packed, lens.long()), {}),                 # lens dtype
            ((bm.long(), packed, lens), {}),                 # bitmap dtype
            ((bm, packed.to(torch.int8), lens), {}),         # packed dtype
            ((bm, packed[:, :-2], lens), {}),                # Lq % 4 != 0
            ((bm, packed.t().contiguous().t(), lens), {}),   # not contiguous
            ((bm, packed, lens[:-1]), {}),                   # rows of lens
            ((bm[None], packed, lens), {}),                  # bitmap shape
            ((bm, packed.to(meta), lens), {}),               # a CPU tensor
            ((bm.to(meta), packed.to(meta), lens.to(meta)), {}),  # no kernel
            ((bm, packed, lens), {"seed_k": 17}),
            ((bm, packed, lens), {"stride": 3}),
            ((bm, packed, lens), {"k_budget": -1})):
        with pytest.raises((TypeError, ValueError)):
            fr.seed_filter_compact(*args, **{**kw, **extra})


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_seed_filter_compact_on_cpu_is_the_plain_chain(stride):
    """On CPU tensors the wrapper is the plain version: the hits of the
    unpacked filter on the same rows (ops/seed_filter, at the boundary
    lengths of every phase), and argsort's stable pass-first order."""
    from centroflye_tpu_torch.ops.seed_filter import seed_hit_counts_bitmap
    rng = np.random.default_rng(stride)
    unit = rng.integers(0, 4, 120).astype(np.int8)
    codes, lens = _small_batch(rng, unit, B=64, L=1024)
    lens[16:16 + 48] = boundary_lens(SEED_K, 1024 // 16)
    packed = torch.from_numpy(_pack(codes, lens))
    lens_t = torch.from_numpy(lens)
    bm = _bitmap_words(unit)
    out, top = fr.seed_filter_compact(bm, packed, lens_t, **_kw(120, stride))
    seq = "".join("ACGT"[c] for c in unit)
    want = seed_hit_counts_bitmap(
        words_tensor(build_seed_bitmap(seq, SEED_K), "cpu"),
        torch.from_numpy(codes), lens_t, k=SEED_K, stride=stride)
    B = lens.shape[0]
    assert torch.equal(out[2 * B:3 * B], want)
    fail = want < max(1, 8 // stride)
    assert int(out[3 * B]) == int((~fail).sum()) > 0
    assert (out[:2 * B] == 120).all()
    assert torch.equal(top, torch.argsort(fail.to(torch.int32),
                                          stable=True)[:K_BUDGET])


@pytest.mark.parametrize("path", ["packed", "n_mask", "seed_k", "stride"])
def test_filter_kernel_steps_counts_packed_steps(path):
    """`fused.filter_kernel_steps` counts one a step on the packed path
    and none on the unpacked path (an N mask, seed_k > 16, a stride
    outside 1, 2, 4)."""
    from centroflye_tpu_torch.utils.logging_utils import Recording
    rng = np.random.default_rng(8)
    unit = rng.integers(0, 4, 90).astype(np.int8)
    codes, lens = _small_batch(rng, unit)
    seq = "".join("ACGT"[c] for c in unit)
    kw = dict(m=90, seed_k=17 if path == "seed_k" else SEED_K, min_hits=8,
              k_budget=8, stride=3 if path == "stride" else 2,
              seed_bitmap_le=words_tensor(build_seed_bitmap(seq, SEED_K,
                                                            le=True), "cpu"))
    fused = fr.make_fused_recruit(
        words_tensor(build_seed_bitmap(seq, SEED_K), "cpu"),
        words_tensor(build_peq(unit), "cpu"),
        words_tensor(build_peq(revcomp(unit)), "cpu"), **kw)
    if path == "n_mask":
        codes[5, 10:20] = 4
    packed, n_mask = fr.pack_2bit(codes, lens)
    assert (n_mask is not None) == (path == "n_mask")
    rec = Recording()
    with recording(rec):
        for _ in range(3):
            fused.raw(packed, n_mask, lens)
    want = 3 if path == "packed" else 0
    assert rec.counters.get("fused.filter_kernel_steps", 0) == want


@pytest.mark.gpu
@pytest.mark.parametrize("stride", [1, 2, 4])
@pytest.mark.parametrize("unit_name", ["DXZ1_rc", "D6Z1"])
def test_seed_filter_kernel_equals_plain(cuda, unit_name, stride):
    """The kernel's bundle and pass order equal the plain version's, bit
    for bit, at 256 and 64 rows (a four-card shard) of 32,768 columns,
    n_pass 0, 1, 11, 128 and 200 (overflow) of 256 and 0, 1, 11, 64 of
    64, passing rows first or scattered; and the fused step's bundle on
    the card (the kernel, then K1c) equals K1 on the pass order's rows
    whole, with one launch of each kernel."""
    rng = np.random.default_rng(stride)
    unit = _unit(unit_name)
    m = len(unit)
    bm = _bitmap_words(unit)
    bm_card = bm.to(cuda)
    fused = _fused(unit, stride, cuda)
    peq_f = words_tensor(build_peq(unit), cuda)
    peq_r = words_tensor(build_peq(revcomp(unit)), cuda)
    kw = _kw(m, stride)
    pools = Pools(rng, unit, 256, stride, bm)
    for B, counts in ((256, (0, 1, 11, 128, 200)), (64, (0, 1, 11, 64))):
        for n_pass in counts:
            for scattered in (False, True):
                packed, lens = pools.case(rng, B, n_pass, scattered)
                p_t, l_t = torch.from_numpy(packed), torch.from_numpy(lens)
                want_out, want_top = fr.seed_filter_compact(bm, p_t, l_t,
                                                            **kw)
                got_out, got_top = fr.seed_filter_compact(
                    bm_card, p_t.to(cuda), l_t.to(cuda), **kw)
                where = (unit_name, stride, B, n_pass, scattered)
                assert torch.equal(got_out.cpu(), want_out), where
                assert torch.equal(got_top.cpu(), want_top), where

                # the fused step: the kernel, then K1c, against K1 whole
                before = (fr.seed_filter_compact.launches,
                          myers_hw_chunks.launches)
                got = fused.raw(p_t.to(cuda), None, l_t.to(cuda))
                assert (fr.seed_filter_compact.launches,
                        myers_hw_chunks.launches) == (before[0] + 1,
                                                      before[1] + 1)
                top = want_top.to(cuda)
                codes = fr._unpack_nomask(p_t.to(cuda)[top])
                dist_f, dist_r = recruit_distances(
                    peq_f, peq_r, codes, l_t.to(cuda)[top], m=m)
                want = want_out.to(cuda)
                ok = want[2 * B:3 * B][top] >= kw["min_hits"]
                want[:B][top] = torch.where(ok, dist_f, m)
                want[B:2 * B][top] = torch.where(ok, dist_r, m)
                assert torch.equal(got, want), where


@pytest.mark.gpu
def test_packed_fused_step_is_two_launches(cuda):
    """A packed fused step with its rows on the card runs two kernels, the
    filter's and K1c's, and no ATen kernel (torch.profiler's kernel
    records), and counts one launch of each wrapper."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(11)
    unit = _unit("DXZ1_rc")
    pools = Pools(rng, unit, 256, 2, _bitmap_words(unit))
    packed, lens = pools.case(rng, 256, 11, True)
    packed, lens = (torch.from_numpy(packed).to(cuda),
                    torch.from_numpy(lens).to(cuda))
    fused = _fused(unit, 2, cuda)
    fused.raw(packed, None, lens)                   # warm-up: the ticket
    torch.cuda.synchronize()
    before = fr.seed_filter_compact.launches, myers_hw_chunks.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused.raw(packed, None, lens)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.device_type() == DeviceType.CUDA
                     and not getattr(e, "is_user_annotation",
                                     lambda: False)()),
                    key=lambda e: e.start_ns())
    names = [e.name() for e in events]
    assert len(names) == 2, names
    assert "seed_filter_compact" in names[0], names
    assert "myers_hw_wavefront_chunks" in names[1], names
    assert (fr.seed_filter_compact.launches,
            myers_hw_chunks.launches) == (before[0] + 1, before[1] + 1)
