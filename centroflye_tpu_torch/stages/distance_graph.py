"""Distance-graph recruitment of unique k-mers (the reference's 9h stage),
the JAX package's `stages/distance_graph.py` in PyTorch.

Reference behavior (distance_based_kmer_recruitment.py:85-149): for every
unit-distance d in [min_d, max_d] and every read, count ordered co-occurrences
of rare-k-mer pairs (i in cloud t, j in cloud t+d, i != j) into a sparse
(kmer x kmer x dist) structure of Python dicts — the 9h/800GB RAM blow-up.
filter_dist_tuples then keeps an edge (i, j, d) iff count >= min_coverage AND
that d carries >= rel_threshold (0.8) of all distance-counts for (i, j);
endpoint k-mers of surviving edges are the unique k-mers.

A pair observation is one int64 key `i << 32 | j << 8 | d` (i, j < 2^24
rare-k-mer indices, d < 2^8), so the whole tensor is a sorted table of keys
and counts (ops/kmers), and an (i, j) group is a run of `key >> 8`.

Pair generation is EXACT-RAGGED: the host plans, per i-range strip, the
populated (read, unit t, distance d) cells; the device expands them into
SUB-BUCKETS — each bucket split along its smaller cloud side, one element
of it (its k-mer value fetched once) times the whole larger side — and
enumerates the strip's pair range [0, total) in chunks. A scatter of the
sub-bucket boundary deltas and a cumulative sum give each pair index its
sub-bucket; one gather fetches the iterated side. Every key entering a
sort is a true pair observation.

The key space is STRIPED by i so every table is bounded: cloud rows are
sorted, so a strip's elements within a row form one contiguous segment
(bounds read off host value-threshold counts). A strip that fits one chunk
is sorted raw and filtered from run lengths; larger strips count chunk
tables and merge them in a binary forest, splitting the strip in half if
its distinct keys overflow `max_capacity`. Groups (i, j) never straddle a
strip, so `recruit_unique_kmers` filters each strip on the device and only
the surviving edges reach the host.

With a mesh (`parallel/mesh.Mesh` of more than one device) every strip is
planned on the host (no device grid, as in the JAX package), the flat
cloud array and each segment's sub-bucket list sit on every shard's
device, and each chunk's pair range splits by shard
(`parallel/mesh.make_pair_bucket_step`); the shards' tables fold on the
mesh's first device, so the edges are the single-device ones.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from centroflye_tpu_torch.config import KmerRecruitmentConfig
from centroflye_tpu_torch.ops.kmers import (
    KEY_SENTINEL, count_unique, merge_count_tables, split_keys,
)
from centroflye_tpu_torch.parallel.mesh import (
    Mesh, make_pair_bucket_step, replicate)

logger = logging.getLogger("centroflye_tpu_torch")
_FAR = 1 << 62        # beyond every position and every cumulative count


class _StripOverflow(Exception):
    """A strip's distinct-key count exceeded max_capacity: the sweep
    splits the strip's i-range in half and retries (bounded device
    memory is a hard invariant)."""


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(int(x), 1)))))


def _fill_by_boundaries(cols, bpos: torch.Tensor, size: int):
    """Per-slot copies of the entries of each column in `cols` (1-D
    tensors of one length): entry e covers the slots from bpos[e - 1]
    (entry 0 from slot 0) to the next boundary. Scattering the entry
    deltas at the boundaries and taking a cumulative sum reconstructs
    each column exactly, in O(entries + size) adds. Boundaries must be
    >= 0; those at or past `size` drop (into a spare slot), and empty
    entries collapse onto one slot. Returns one (size,) tensor per
    column. Each column is scanned on its own: a 1-D contiguous cumsum
    is one parallel scan on CUDA, where a cumsum along dim 0 of a
    (size, C) grid runs one thread per column."""
    at = bpos.clamp(max=size)
    out = []
    for v in cols:
        grid = torch.zeros(size + 1, dtype=torch.int64, device=v.device)
        grid[0] = v[0]
        grid.index_add_(0, at, v[1:] - v[:-1])
        out.append(torch.cumsum(grid[:size], dim=0))
    return out


def _pair_keys(flat, starts, const_vals, base_iter, a_const, dvals,
               c0: int, total: int, chunk: int) -> torch.Tensor:
    """Keys of pairs [c0, c0 + chunk) of a sub-bucket list (KEY_SENTINEL
    past `total` and where i == j).

    Sub-bucket e holds pairs [starts[e], starts[e+1]); within it, y = p -
    starts[e] indexes the iterated (larger) side, whose cloud slice
    starts at flat[base_iter[e]]; const_vals[e] is the constant (smaller)
    side's k-mer index and a_const[e] says whether it is the i side. The
    iterated-side offset, the constant value and (a_const << 8 | d) are
    filled per pair by `_fill_by_boundaries`; boundaries before the chunk
    clip to its first slot."""
    dev = flat.device
    p = torch.arange(chunk, dtype=torch.int64, device=dev) + c0
    off, c, ad = _fill_by_boundaries(
        [base_iter - starts[:-1], const_vals, (a_const << 8) | dvals],
        (starts[1:-1] - c0).clamp(min=0), chunk)
    # past `total` the offset can leave the cloud tensor: clamp the read
    # (the row is masked below)
    g = flat[(off + p).clamp(0, flat.numel() - 1)].long()
    a_is_const = (ad >> 8) == 1
    a = torch.where(a_is_const, c, g)
    b = torch.where(a_is_const, g, c)
    valid = (p < total) & (a != b)
    return torch.where(valid, (a << 32) | (b << 8) | (ad & 0xFF),
                       KEY_SENTINEL)


def _pairs_from_buckets(flat, starts, const_vals, base_iter, a_const, dvals,
                        c0: int, total: int, *, chunk: int, capacity: int):
    """Count the keys of one chunk of a strip's pair range: a sorted
    `capacity` (key -> count) table (ukeys, counts, n)."""
    return count_unique(_pair_keys(flat, starts, const_vals, base_iter,
                                   a_const, dvals, c0, total, chunk),
                        capacity=capacity)


def _sorted_pairs(flat, starts, const_vals, base_iter, a_const, dvals,
                  total: int, *, chunk: int) -> torch.Tensor:
    """RAW-PAIR fast path: one whole strip's pair keys, sorted (no count
    table, no merge forest). Per-key counts are then the run lengths of
    the sorted stream (_count_filter_sorted). KEY_SENTINEL rows sort to
    the back."""
    return torch.sort(_pair_keys(flat, starts, const_vals, base_iter,
                                 a_const, dvals, 0, total, chunk)).values


def _marked(mark, vals, fill):
    """(buf, rank): buf holds `vals` of the marked elements in order,
    then `fill` (one spare slot takes the unmarked writes); rank is the
    count of marked elements at or before each element. This stands for
    the JAX package's cummin/cummax scans: with vals not decreasing, the
    nearest marked element is the extreme one, and a 1-D cumsum is one
    parallel scan on CUDA where a 1-D cummin/cummax runs in one block."""
    n = mark.numel()
    rank = torch.cumsum(mark, 0)
    buf = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    buf.scatter_(0, torch.where(mark, rank - 1, n), vals)
    return buf, rank


def _nearest_right(mark, vals, fill):
    """Per element, `vals` at the nearest marked element at or after it,
    `fill` if there is none (vals must not decrease)."""
    buf, rank = _marked(mark, vals, fill)
    # marks strictly before an element index the first one at or after
    # it; past the last mark the slot holds `fill` (never the spare)
    return buf[rank - mark.long()]


def _nearest_left(mark, vals, fill):
    """Per element, `vals` at the nearest marked element at or before it,
    `fill` if there is none (vals must not decrease)."""
    buf, rank = _marked(mark, vals, fill)
    return torch.where(rank > 0, buf[(rank - 1).clamp(min=0)], fill)


def _edge_rule(cnt, all_occ, min_cov: int, num: int, den: int, rel: float,
               use_frac: bool):
    """count >= min_coverage and count / all_occ >= rel: the integer
    cross-multiplication when rel is the exact fraction num/den (the
    default 0.8 = 4/5), else in float32 as the JAX package does."""
    if use_frac:
        ok_rel = cnt * den >= all_occ * num
    else:
        rel32 = torch.tensor(rel, dtype=torch.float32, device=cnt.device)
        ok_rel = cnt.to(torch.float32) >= rel32 * all_occ.to(torch.float32)
    return (cnt >= min_cov) & ok_rel


def _boundaries(keys: torch.Tensor):
    """(valid, key-run starts, key-run ends, (i, j)-group starts,
    group ends) of a sorted key array."""
    valid = keys != KEY_SENTINEL
    one = torch.ones(1, dtype=torch.bool, device=keys.device)
    knew = torch.cat([one, keys[1:] != keys[:-1]])
    grp = keys >> 8
    gnew = torch.cat([one, grp[1:] != grp[:-1]])
    return (valid, knew & valid, torch.cat([knew[1:], one]) & valid,
            gnew & valid, torch.cat([gnew[1:], one]) & valid)


def _raw_keep(keys, min_cov, num, den, rel, use_frac):
    """Count + distance-consistency filter on a strip's SORTED raw pair
    stream (reference distance_based_kmer_recruitment.py:111-149): the
    count of (i, j, d) is the run length of its key, all_occ(i, j) the
    length of its (i, j) group, both read off nearest-boundary scans over
    positions. Returns (keep, count); both hold at key-run starts."""
    iota = torch.arange(keys.numel(), dtype=torch.int64, device=keys.device)
    _, kstart, kend, gstart, gend = _boundaries(keys)
    cntd = _nearest_right(kend, iota, _FAR) - iota + 1
    all_occ = (_nearest_right(gend, iota, _FAR)
               - _nearest_left(gstart, iota, 0) + 1)
    keep = kstart & _edge_rule(cntd, all_occ, min_cov, num, den, rel,
                               use_frac)
    return keep, cntd


def _table_keep(keys, cnt, min_cov, num, den, rel, use_frac):
    """The distance-consistency KEEP mask of a sorted (key -> count)
    table: an (i, j) group's total is the difference of the cumulative
    count at its last row and before its first (nearest-boundary scans
    over the cumulative sum, which only grows)."""
    valid, _, _, gstart, gend = _boundaries(keys)
    cnt_v = torch.where(valid, cnt.long(), 0)
    csum = torch.cumsum(cnt_v, dim=0)
    all_occ = (_nearest_right(gend, csum, _FAR)
               - _nearest_left(gstart, csum - cnt_v, 0))
    return valid & _edge_rule(cnt_v, all_occ, min_cov, num, den, rel,
                              use_frac)


def _mark_seen(seen, keep, keys):
    """Flag the endpoints of kept edges in `seen`, whose last slot takes
    the dropped writes (indices past the rare table, as JAX drops them)."""
    n = seen.numel() - 1
    for v in (keys >> 32, (keys >> 8) & 0xFFFFFF):
        seen[torch.where(keep & (v < n), v, n)] = 1
    return seen


def _count_filter_sorted(seen, keys, min_cov, num, den, rel, *,
                         use_frac: bool):
    """Count + filter a RAW strip (`_raw_keep`) and flag the kept edges'
    endpoints in `seen`. Returns (seen, keep, count)."""
    keep, cntd = _raw_keep(keys, min_cov, num, den, rel, use_frac)
    return _mark_seen(seen, keep, keys), keep, cntd


def _filter_keep_mask(seen, keys, cnt, min_cov, num, den, rel, *,
                      use_frac: bool):
    """Filter a TABLE strip (`_table_keep`) and flag the kept edges'
    endpoints in `seen` (the unique-k-mer set never depends on edge
    materialization). Returns (seen, keep)."""
    keep = _table_keep(keys, cnt, min_cov, num, den, rel, use_frac)
    return _mark_seen(seen, keep, keys), keep


def _kept_edges(keep, keys, cnt):
    """The kept rows' edges in key order, as host int64 arrays (i, j, d,
    count): one index of the kept rows (its length is the strip's one
    sync) and one gather a column."""
    idx = keep.nonzero().squeeze(1)
    k = keys[idx]
    return tuple(v.cpu().numpy() for v in (
        k >> 32, (k >> 8) & 0xFFFFFF, k & 0xFF, cnt[idx].long()))


def _prep_strip_device(flat, seg_packed, sizes_flat, nnz: int, nb: int,
                       total_subs: int, total_pairs: int, *, min_d: int,
                       d_hi: int, T: int, Kp: int, NZCAP: int,
                       NBCAP: int, Spad: int):
    """Device-side SPARSE strip prep: derive the strip's SUB-BUCKET
    arrays from its packed (seg_lo << 16 | seg_len) plane, enumerating
    ONLY the (read, unit) cells that hold strip elements, crossed with
    their valid distances. Pipeline: compact the nonzero cells (a sort
    of the (R*T,) plane), expand each by its valid-distance count
    (`_fill_by_boundaries` at NBCAP), then expand buckets into
    sub-buckets at Spad. Outputs feed `_pair_keys`: (starts (Spad+1,),
    const_vals, base_iter, a_const, dvals). Bucket order is (cell-major,
    d-inner); any order enumerates every pair exactly once."""
    dev = flat.device
    RT = seg_packed.numel()
    iota_rt = torch.arange(RT, dtype=torch.int64, device=dev)
    # nonzero-cell indices to the front
    nzkey = torch.where((seg_packed & 0xFFFF) > 0, iota_rt, RT)
    if NZCAP > RT:          # tiny planes: pad to NZCAP
        nzkey = torch.cat([nzkey, nzkey.new_full((NZCAP - RT,), RT)])
    nz_idx = torch.sort(nzkey).values[:NZCAP]
    zvalid = torch.arange(NZCAP, device=dev) < nnz
    vd = ((T - 1 - nz_idx % T).clamp(max=d_hi) - min_d + 1).clamp(min=0)
    vd = torch.where(zvalid, vd, 0)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    bcum = torch.cat([zero, torch.cumsum(vd, dim=0)])
    idx_a, b0 = _fill_by_boundaries([nz_idx, bcum[:-1]], bcum[1:-1],
                                    NBCAP)

    eb = torch.arange(NBCAP, dtype=torch.int64, device=dev)
    bvalid = eb < nb
    d = min_d + (eb - b0)
    idx_b = (idx_a + d).clamp(0, RT - 1)
    seg = seg_packed[torch.where(bvalid, idx_a, 0).clamp(0, RT - 1)]
    aseg = torch.where(bvalid, seg & 0xFFFF, 0)
    # seg_lo occupies the high 16 bits and can reach Kp-1: mask it after
    # the shift, as the JAX package does for its signed int32 plane
    alo = (seg >> 16) & 0xFFFF
    nbv = torch.where(bvalid, sizes_flat[idx_b], 0)
    ba = idx_a * Kp + alo
    bb = idx_b * Kp
    am = nbv >= aseg
    cbase = torch.where(am, ba, bb)
    ibase = torch.where(am, bb, ba)
    ilen = torch.where(am, nbv, aseg)
    bstart = torch.cat([zero, torch.cumsum(aseg * nbv, dim=0)])
    sstart = torch.cat([zero, torch.cumsum(torch.minimum(aseg, nbv),
                                           dim=0)])
    s0, cb, b0, il, ib, ac, dv = _fill_by_boundaries(
        [sstart[:-1], cbase, bstart[:-1], ilen, ibase, am.long(),
         torch.where(bvalid, d, 0)], sstart[1:-1], Spad)

    e = torch.arange(Spad, dtype=torch.int64, device=dev)
    x = e - s0
    cv = flat[(cb + x).clamp(0, flat.numel() - 1)].long()
    st = b0 + x * il
    pad = e >= total_subs
    st = torch.where(pad, total_pairs, st)
    cv, bi, ac, dvs = (torch.where(pad, 0, v) for v in (cv, ib, ac, dv))
    starts = torch.cat([st, zero + total_pairs])
    return starts, cv, bi, ac, dvs


def _expand_subbuckets(flat_host: np.ndarray, counts: np.ndarray,
                       ba: np.ndarray, bb: np.ndarray, nbv: np.ndarray,
                       dvv: np.ndarray):
    """Split each (read, unit, distance) bucket along its smaller cloud
    side into sub-buckets of (one smaller-side element) x (whole larger
    side). The smaller side's k-mer values are gathered from the flat
    cloud array ON HOST (cheap: one value per sub-bucket); the device
    then needs a single gather per pair. Returns flat arrays over
    sub-buckets: (counts, const_vals, base_iter, a_const, dv)."""
    seg = (counts // np.maximum(nbv, 1)).astype(np.int64)  # A-side sizes
    a_major = nbv >= seg          # expand A side when B side is larger
    n_sub = np.where(a_major, seg, nbv).astype(np.int64)
    sub_of = np.repeat(np.arange(len(counts)), n_sub)
    first = np.cumsum(n_sub) - n_sub
    x = np.arange(len(sub_of), dtype=np.int64) - first[sub_of]
    am = a_major[sub_of]
    const_base = np.where(am, ba[sub_of], bb[sub_of]).astype(np.int64)
    const_vals = flat_host[const_base + x]
    base_iter = np.where(am, bb[sub_of], ba[sub_of]).astype(np.int32)
    sub_counts = np.where(am, nbv[sub_of], seg[sub_of]).astype(np.int64)
    return (sub_counts, const_vals.astype(np.int32), base_iter,
            am.astype(np.int32), dvv[sub_of])


def _strip_buckets(seg_lo: np.ndarray, seg_len: np.ndarray,
                   sizes: np.ndarray, n_units: np.ndarray,
                   min_d: int, d_hi: int, T: int, Kp: int):
    """Pair buckets of one strip: every populated (read, unit t, distance
    d) triple contributes seg_len[r, t] * sizes[r, t+d] ordered pairs
    (A = the row's contiguous strip segment, B = the full partner cloud —
    rows are sorted with -1 padding behind the valid entries, so both are
    contiguous slices). Returns (counts int64, base_a, base_b, nb, dv)
    flat arrays over nonzero buckets, or None if the strip is empty.
    Pure vectorized numpy; strip membership is exact by construction."""
    parts = []
    for d in range(min_d, min(d_hi, T - 1) + 1):
        na = seg_len[:, :T - d].astype(np.int64)
        nb = sizes[:, d:].astype(np.int64)
        ok = (np.arange(T - d, dtype=np.int64)[None, :] + d
              ) < n_units[:, None]
        cnt = np.where(ok, na * nb, 0).ravel()
        nz = np.flatnonzero(cnt)
        if nz.size == 0:
            continue
        r = nz // (T - d)
        t = nz - r * (T - d)
        parts.append((
            cnt[nz],
            ((r * T + t) * Kp
             + seg_lo[:, :T - d].ravel()[nz]).astype(np.int32),
            ((r * T + t + d) * Kp).astype(np.int32),
            nb.ravel()[nz].astype(np.int32),
            np.full(nz.size, d, np.int32),
        ))
    if not parts:
        return None
    return tuple(np.concatenate([p[i] for p in parts])
                 for i in range(5))


def estimate_pair_capacity(clouds_tensor: np.ndarray,
                           n_units: np.ndarray,
                           config: KmerRecruitmentConfig,
                           *, cap: int = 1 << 26) -> int:
    """Static table capacity from cloud-size statistics: the distinct
    (i, j, d) key count is bounded by the total pair-observation count
    sum_r sum_d sum_t |cloud_t||cloud_{t+d}|, computable from the cloud
    sizes alone."""
    total = _pair_obs_bound(clouds_tensor, n_units, config)
    return 1 << max(16, int(np.ceil(np.log2(max(min(total, cap), 2)))))


def _strip_sweep(
    clouds_tensor: np.ndarray,        # (R, T, K) int32, -1 padded
    n_units: np.ndarray,              # (R,) int32
    config: KmerRecruitmentConfig,
    *,
    capacity: Optional[int] = None,
    entry_chunk: Optional[int] = None,
    element_budget: int = 63 << 20,
    strip_capacity: int = 1 << 26,
    subbucket_budget: int = 8 << 20,
    dedup_hint: int = 1,
    max_capacity: int = 1 << 27,
    adaptive: bool = True,
    yield_raw: bool = False,
    device="cuda",
    mesh=None,
):
    """Yield one sorted (i, j, d) -> count device table per i-range strip,
    strips in ascending i order (so concatenating valid prefixes yields
    the globally sorted table): (keys, counts, None, capacity), or, for a
    strip sorted raw under `yield_raw`, (keys, None, -1, total_pairs).

    The key space is striped by i so each strip's table is bounded. Pair
    emission is EXACT: per strip the device expands the populated (read,
    unit, distance) buckets into sub-buckets and enumerates pair indices
    [0, total) in chunks of `entry_chunk` PAIRS. Chunk tables are sized
    to the chunk (no overflow possible, no host syncs) and merge into a
    binary forest; doubling on overflow remains the fallback for
    capacity-saturated merges only, and a strip whose table would pass
    `max_capacity` splits in half. A strip past the device grid's limits
    is planned on the host per SEGMENT (bucket slices bounded by pair
    and sub-bucket counts), so peak host memory is O(segment)."""
    t_plan = time.perf_counter()
    R, T, K = clouds_tensor.shape
    # key packing is i << 32 | j << 8 | d, and the filter regroups by
    # key >> 8 — both alias silently if these bounds are exceeded
    if config.max_distance >= 256:
        raise ValueError(
            f"max_distance {config.max_distance} >= 256 overflows the "
            "8-bit distance field of the packed key")
    max_idx = int(clouds_tensor.max()) if clouds_tensor.size else 0
    if max_idx >= 1 << 24:
        raise ValueError(
            "rare k-mer index >= 2^24 overflows the packed pair key")
    # canonicalize rows: ascending valid entries front-packed, -1 pads
    # behind (strip segments and B-cloud slices index contiguous valid
    # prefixes; pad_clouds already emits this layout, synthetic callers
    # may not; within-cloud order cannot change any (i, j, d) count)
    if clouds_tensor.size:
        srt = np.sort(clouds_tensor, axis=2)      # any -1 pads sort first
        n_inv = (srt < 0).sum(axis=2, keepdims=True)
        idx = (np.arange(K, dtype=np.int64)[None, None, :] + n_inv) % K
        clouds_tensor = np.take_along_axis(srt, idx, axis=2)
    bound = _pair_obs_bound(clouds_tensor, n_units, config)
    if capacity is None:
        capacity = 1 << max(
            16, int(np.ceil(np.log2(max(min(bound, strip_capacity), 2)))))
    max_capacity = max(max_capacity, capacity)
    # strip sizing: the pair-obs bound assumes every observation mints a
    # distinct (i, j, d) key; dedup_hint divides it for STRIP COUNT only.
    # 0.94 margin: strips whose raw pair count lands just over capacity
    # lose the no-overflow proof and pay a host sync per saturated merge
    n_strips = max(1, -(-bound // max(
        int(capacity * 0.94) * max(dedup_hint, 1), 1)))
    strip_w = max(1, -(-(max_idx + 1) // n_strips))
    n_strips = max(1, -(-(max_idx + 1) // strip_w))

    # without a mesh, the sweep runs as the one shard of `device`
    if mesh is None or mesh.size <= 1:
        mesh = Mesh([device])
    n_dev, device = mesh.size, mesh.first
    if entry_chunk is None:
        entry_chunk = max(1, min(element_budget, capacity))
    # chunks split evenly over the shards
    entry_chunk = -(-entry_chunk // n_dev) * n_dev
    # tail chunks use a 16x smaller shape: per-strip remainders would
    # otherwise pad up to a full chunk each
    tail_chunk = -(-max(n_dev, entry_chunk // 16) // n_dev) * n_dev

    Kp = max(K, 1)
    flat_host = np.ascontiguousarray(
        clouds_tensor.reshape(-1), dtype=np.int32)
    if flat_host.size == 0:
        flat_host = np.full(1, -1, np.int32)
    if int(np.int64(R) * T * Kp) >= 1 << 31:
        raise ValueError("flat cloud tensor exceeds int32 addressing")
    flat_dev = replicate(mesh, flat_host)       # a copy a distinct device
    # per-cloud sizes, masked to live unit instances
    sizes = (clouds_tensor >= 0).sum(axis=2).astype(np.int64)  # (R, T)
    live = np.arange(T, dtype=np.int64)[None, :] < \
        np.asarray(n_units, np.int64)[:, None]
    sizes = np.where(live, sizes, 0)
    d_hi = min(config.max_distance, T - 1)

    # per-strip contiguous segments of each sorted row, computed ON
    # DEMAND per strip boundary (element counts below a value threshold)
    # — strips are a WORKLIST of [lo, hi) value ranges so an
    # overflowing strip can split in half and retry
    vmask = clouds_tensor >= 0
    zeros_rt = np.zeros_like(sizes)
    below_cache: Dict[int, np.ndarray] = {}

    def below_count(v: int) -> np.ndarray:
        if v <= 0:
            return zeros_rt
        if v > max_idx:
            return sizes
        if v not in below_cache:
            below_cache[v] = ((clouds_tensor < v) & vmask).sum(axis=2)
        return below_cache[v]

    # pair counts are LINEAR in the strip's per-(read, unit) element
    # counts: pairs(strip) = sum_{r,t} seg_len[r,t] * W[r,t] with
    # W[r,t] = sum_{d in [min_d, d_hi], t+d < T} sizes[r, t+d]
    _scs = np.concatenate(
        [np.cumsum(sizes[:, ::-1], axis=1)[:, ::-1],
         np.zeros((R, 1), np.int64)], axis=1)   # suffix sums, (R, T+1)
    _w_lo = np.minimum(np.arange(T) + config.min_distance, T)
    _w_hi = np.minimum(np.arange(T) + d_hi + 1, T)
    pair_weight = np.take_along_axis(_scs, _w_lo[None, :], axis=1) - \
        np.take_along_axis(_scs, _w_hi[None, :], axis=1)   # (R, T)

    def pair_count(lo: int, hi: int) -> int:
        return int(((below_count(hi) - below_count(lo))
                    .astype(np.int64) * pair_weight).sum())

    # per-strip proof that capacity-saturated tables cannot overflow:
    # distinct keys <= the strip's pair-observation bound, so when that
    # bound fits the capacity every check-and-double host sync is dead
    strip_no_ovf = [False]
    dedup_obs = [None]
    dedup_samples: List[float] = []
    sweep_grid = [None]  # once-per-sweep device sizes plane + vd counts
    steps = {}                  # (chunk, capacity) -> the sharded step

    def run_chunk(bufs, c0, total, chunk):
        """One pair-range chunk -> (table, cap). The chunk table covers
        the chunk's pair count, so overflow is impossible whenever the
        strip capacity allows it and NO host sync happens."""
        nonlocal capacity
        cap = min(_next_pow2(chunk), capacity)
        while True:
            if (chunk, cap) not in steps:
                steps[chunk, cap] = make_pair_bucket_step(
                    mesh, chunk=chunk, capacity=cap)
            ukeys, cnt, n = steps[chunk, cap](flat_dev, *bufs, c0, total)
            if cap >= chunk or strip_no_ovf[0] or int(n) <= cap:
                return (ukeys, cnt), cap
            cap *= 2
            if cap > max_capacity:
                raise _StripOverflow
            if cap > capacity:
                capacity = cap

    logger.info(
        "distance sweep: %d strip(s), chunk %d pairs, capacity %d, "
        "pair-obs bound %d", n_strips, entry_chunk, capacity, bound,
        extra={"counts": {"pair_obs": bound}})
    yielded = False
    # LIFO worklist of [lo, hi) i-value ranges, seeded with the uniform
    # grid and popped in ascending order (splits push their halves back
    # in order) — yields stay globally sorted by i
    work = [(s * strip_w,
             (s + 1) * strip_w if n_strips > 1 else max(max_idx + 1, 1))
            for s in range(n_strips)][::-1]
    plan_s = time.perf_counter() - t_plan
    while work:
        s_lo, s_hi = work.pop()
        t_strip = time.perf_counter()
        lo_c = below_count(s_lo)
        seg_lo = lo_c
        seg_len = below_count(s_hi) - lo_c
        # cheap reductions first: strip pair/sub-bucket totals without
        # materializing the bucket grid on host
        total_strip = int((seg_len.astype(np.int64) * pair_weight).sum())
        total_subs = 0
        for d in range(config.min_distance, d_hi + 1):
            if d >= T:
                break
            total_subs += int(np.minimum(
                seg_len[:, :T - d], sizes[:, d:]).sum())
        if total_strip == 0:
            plan_s += time.perf_counter() - t_strip
            continue
        strip_no_ovf[0] = total_strip <= capacity
        # device-grid path: the bucket grid and sub-bucket expansion are
        # derived ON DEVICE from the (R, T) strip segments; a mesh (whose
        # step takes the sub-bucket list on every device), a strip past
        # int32 pair indexing, or clouds of 2^16 k-mers or more (the
        # packed plane's 16-bit fields) are planned on the host
        devgrid = (n_dev == 1 and total_strip < (1 << 31)
                   and total_subs < (1 << 31) and Kp < (1 << 16))
        nb_buckets = sum(R * max(0, T - d) for d in range(
            config.min_distance, d_hi + 1))
        n_subs_log = total_subs
        seg_bounds = None
        if not devgrid:
            buckets = _strip_buckets(seg_lo, seg_len, sizes, n_units,
                                     config.min_distance, d_hi, T, Kp)
            if buckets is None:
                plan_s += time.perf_counter() - t_strip
                continue
            cnts_b, ba, bb, nbv, dvv = buckets
            # per-bucket sub-bucket count (the smaller cloud side): host
            # expansion memory is proportional to it, so segment the
            # BUCKET list first and expand per segment
            n_sub_b = np.minimum(cnts_b // np.maximum(nbv, 1), nbv)
            bcum = np.concatenate([[0], np.cumsum(cnts_b)])
            bscum = np.concatenate([[0], np.cumsum(n_sub_b)])
            n_subs_log = int(bscum[-1])
            total_strip = int(bcum[-1])
            if total_strip == 0:
                plan_s += time.perf_counter() - t_strip
                continue
            # segments bounded by both pair count (< 2^30) and sub-bucket
            # count (host memory)
            seg_bounds = [0]
            nb_buckets = len(cnts_b)
            while seg_bounds[-1] < nb_buckets:
                b0 = seg_bounds[-1]
                p_lim = int(np.searchsorted(
                    bcum, bcum[b0] + (1 << 30), side="right")) - 1
                s_lim = int(np.searchsorted(
                    bscum, bscum[b0] + subbucket_budget,
                    side="right")) - 1
                nxt = max(min(p_lim, s_lim), b0 + 1)
                seg_bounds.append(min(nxt, nb_buckets))
        plan_s += time.perf_counter() - t_strip

        # binary-counter merge forest: chunk tables enter at their own
        # (power-of-two) capacity and same-sized tables merge pairwise
        # upward. Sub-capacity merges cannot overflow (out capacity = sum
        # of input capacities), so they need NO host sync; only
        # capacity-saturated merges check-and-double.
        forest: Dict[int, tuple] = {}

        def merge_pair(ta, cap_a, tb, cap_b):
            nonlocal capacity
            out = min(_next_pow2(cap_a + cap_b), capacity)
            while True:
                m = merge_count_tables(ta[0], ta[1], tb[0], tb[1],
                                       capacity=out)
                if out >= cap_a + cap_b or strip_no_ovf[0] \
                        or int(m[2]) <= out:
                    return (m[0], m[1]), out
                out *= 2
                if out > max_capacity:
                    raise _StripOverflow
                if out > capacity:
                    capacity = out

        def insert(t, cap):
            while cap in forest:
                other = forest.pop(cap)
                t, cap = merge_pair(other, cap, t, cap)
            forest[cap] = t

        def iter_segments():
            """(bufs, total_seg) per segment — one device-prepped
            segment on the devgrid path, host-expanded slices else."""
            nonlocal plan_s
            if devgrid:
                t0 = time.perf_counter()
                if sweep_grid[0] is None:
                    # once per sweep: sizes plane on device + host
                    # valid-distance counts per unit column
                    sweep_grid[0] = (
                        torch.from_numpy(sizes.ravel()).to(device),
                        np.maximum(np.minimum(
                            d_hi, T - 1 - np.arange(T))
                            - config.min_distance + 1, 0))
                sizes_flat_dev, vd_plane = sweep_grid[0]
                packed = (seg_lo.astype(np.int64) << 16) | seg_len
                nzmask = seg_len > 0
                nnz = int(nzmask.sum())
                nb = int((nzmask * vd_plane[None, :]).sum())
                packed_dev = torch.from_numpy(packed.ravel()).to(device)
                plan_s += time.perf_counter() - t0
                yield _prep_strip_device(
                    flat_dev[0], packed_dev, sizes_flat_dev, nnz, nb,
                    total_subs, total_strip, min_d=config.min_distance,
                    d_hi=d_hi, T=T, Kp=Kp,
                    NZCAP=_next_pow2(max(nnz, 1)),
                    NBCAP=_next_pow2(max(nb, 1)),
                    Spad=_next_pow2(total_subs)), total_strip
                return
            for si in range(len(seg_bounds) - 1):
                b0, b1 = seg_bounds[si], seg_bounds[si + 1]
                t0 = time.perf_counter()
                counts, cvals, biter, aconst, dvs = _expand_subbuckets(
                    flat_host, cnts_b[b0:b1], ba[b0:b1], bb[b0:b1],
                    nbv[b0:b1], dvv[b0:b1])
                cum = np.concatenate([[0], np.cumsum(counts)])
                total_seg = int(cum[-1])
                if total_seg == 0:
                    plan_s += time.perf_counter() - t0
                    continue
                E = len(counts)
                Epad = _next_pow2(E)
                starts_h = np.full(Epad + 1, total_seg, np.int64)
                starts_h[:E + 1] = cum
                arrs = [starts_h]
                for v in (cvals, biter, aconst, dvs):
                    a = np.zeros(Epad, np.int64)
                    a[:E] = v
                    arrs.append(a)
                plan_s += time.perf_counter() - t0
                yield tuple(replicate(mesh, a) for a in arrs), total_seg

        # RAW fast path: a strip that fits one chunk skips the count
        # table, merge forest and overflow machinery entirely — the
        # consumer reads counts as run lengths of the sorted stream
        if yield_raw and devgrid and total_strip <= entry_chunk:
            for bufs, total_seg in iter_segments():
                size = min(max(tail_chunk, _next_pow2(total_seg)),
                           entry_chunk)
                keys = _sorted_pairs(flat_dev[0], *bufs, total_seg,
                                     chunk=size)
            logger.info(
                "distance strip [%d, %d): %d pairs / %d buckets "
                "(%d sub-buckets) raw, %.3fs submit",
                s_lo, s_hi, total_strip, nb_buckets, n_subs_log,
                time.perf_counter() - t_strip,
                extra={"counts": {"strips": 1, "raw_strips": 1}})
            yielded = True
            yield keys, None, -1, total_strip
            continue
        try:
            for bufs, total_seg in iter_segments():
                pos = 0
                while pos < total_seg:
                    rem = total_seg - pos
                    if rem >= entry_chunk:
                        size = entry_chunk
                    else:
                        # pow2-stair tail: ONE chunk rounded up to the
                        # next power of two (floored at tail_chunk) — at
                        # most 2x masked slack, bounded shape variety —
                        # and to a multiple of the shards
                        size = min(-(-max(tail_chunk, _next_pow2(rem))
                                     // n_dev) * n_dev, entry_chunk)
                    t, cap = run_chunk(bufs, pos, total_seg, size)
                    insert(t, cap)
                    pos += size

            # fold surviving forest levels (ascending) into one table
            acc, acc_cap = None, 0
            for cap in sorted(forest):
                if acc is None:
                    acc, acc_cap = forest[cap], cap
                else:
                    acc, acc_cap = merge_pair(acc, acc_cap,
                                              forest[cap], cap)
        except _StripOverflow:
            mid = (s_lo + s_hi) // 2
            if mid <= s_lo:
                raise ValueError(
                    f"distance strip [{s_lo}, {s_hi}) cannot split "
                    f"further yet exceeds max_capacity {max_capacity} "
                    "distinct keys — raise max_capacity")
            logger.info(
                "distance strip [%d, %d) overflowed max capacity %d — "
                "splitting at %d and retrying", s_lo, s_hi,
                max_capacity, mid, extra={"counts": {"strip_splits": 1}})
            work.append((mid, s_hi))
            work.append((s_lo, mid))
            continue
        # ADAPTIVE STRIPING: the uniform grid is sized by the raw
        # pair-observation bound, but every (i, j, d) key is observed
        # once per spanning read with both k-mers surviving, and per-strip
        # fixed costs dominate once tables stop overflowing. Calibrate
        # the dedup (pairs / distinct keys) on the first three executed
        # strips (one scalar sync each) and coalesce the remaining
        # uniform ranges so each future strip carries ~capacity * dedup *
        # 0.75 pairs; the overflow split stays the safety net.
        if adaptive and dedup_obs[0] is None and acc is not None \
                and work:
            n_strip = int((acc[0] != KEY_SENTINEL).sum())
            if n_strip > 0:
                dedup_samples.append(total_strip / n_strip)
            # median of 3 strips: the lowest i-range holds the
            # lexicographically smallest k-mers (low-complexity
            # sequence with inflated counts)
            if len(dedup_samples) >= 3:
                dedup_obs[0] = max(
                    1.0, sorted(dedup_samples)[len(dedup_samples) // 2])
                target = int(capacity * max(1.0, 0.75 * dedup_obs[0]))
                merged, cur = [], None
                for lo, hi in reversed(work):      # ascending ranges
                    if cur is None:
                        cur = (lo, hi)
                    elif cur[1] == lo and \
                            pair_count(cur[0], hi) <= target:
                        cur = (cur[0], hi)
                    else:
                        merged.append(cur)
                        cur = (lo, hi)
                if cur is not None:
                    merged.append(cur)
                if len(merged) < len(work):
                    logger.info(
                        "distance sweep: dedup %.2f observed — "
                        "coalescing %d remaining strips into %d",
                        dedup_obs[0], len(work), len(merged),
                        extra={"counts": {
                            "strips_coalesced": len(work) - len(merged)}})
                work[:] = merged[::-1]
        logger.info(
            "distance strip [%d, %d): %d pairs / %d buckets "
            "(%d sub-buckets), %.3fs submit",
            s_lo, s_hi, total_strip, nb_buckets, n_subs_log,
            time.perf_counter() - t_strip,
            extra={"counts": {"strips": 1, "table_strips": 1,
                              "host_planned_strips": int(not devgrid)}})
        if acc is not None:
            yielded = True
            yield acc[0], acc[1], None, acc_cap
    logger.info("distance sweep: host planning %.3fs", plan_s,
                extra={"seconds": {"sweep_plan": plan_s}})
    if not yielded:
        yield (torch.full((capacity,), KEY_SENTINEL, dtype=torch.int64,
                          device=device),
               torch.zeros(capacity, dtype=torch.int32, device=device),
               0, capacity)


def _pair_obs_bound(clouds_tensor, n_units, config) -> int:
    sizes = (clouds_tensor >= 0).sum(axis=2).astype(np.int64)   # (R, T)
    pos = np.arange(sizes.shape[1])[None, :]
    sizes = np.where(pos < np.asarray(n_units)[:, None], sizes, 0)
    total = 0
    for d in range(config.min_distance, config.max_distance + 1):
        if d >= sizes.shape[1]:
            break
        total += int((sizes[:, :-d] * sizes[:, d:]).sum())
    return total


def build_distance_table(
    clouds_tensor: np.ndarray,        # (R, T, K) int32, -1 padded
    n_units: np.ndarray,              # (R,) int32
    config: KmerRecruitmentConfig,
    *,
    capacity: Optional[int] = None,
    entry_chunk: Optional[int] = None,
    element_budget: int = 64 << 20,
    strip_capacity: int = 1 << 26,
    device="cuda",
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Full (i, j, d) -> count table over all reads and distances,
    MATERIALIZED to host numpy (use recruit_unique_kmers for the
    production path — it filters each strip on device and never
    materializes the table).

    Returns (uhi, ulo, counts, n) as the JAX package does: uint32 words
    and int32 counts sorted by (i, j, d), arrays of length n; decode with
    i = uhi, j = ulo >> 8, d = ulo & 0xFF.
    """
    parts = []
    total = 0
    for keys, cnt, _n, _cap in _strip_sweep(
            clouds_tensor, n_units, config, capacity=capacity,
            entry_chunk=entry_chunk, element_budget=element_budget,
            strip_capacity=strip_capacity, device=device, mesh=mesh):
        n = int((keys != KEY_SENTINEL).sum())
        if n:
            hi, lo = split_keys(keys[:n])
            parts.append((hi.cpu().numpy().astype(np.uint32),
                          lo.cpu().numpy().astype(np.uint32),
                          cnt[:n].cpu().numpy()))
            total += n
    if not parts:
        e = np.empty(0, np.uint32)
        return e, e.copy(), np.empty(0, np.int32), 0
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]), total)


@dataclasses.dataclass
class DistanceEdges:
    """Surviving distance-consistent edges + their endpoint k-mer indices."""

    # parallel arrays of surviving edges
    dist: np.ndarray      # int32
    i: np.ndarray         # int64 k-mer index
    j: np.ndarray         # int64 k-mer index
    freq: np.ndarray      # int64
    unique_kmer_indices: np.ndarray   # sorted int64
    # the edge-coverage cutoff that produced this edge set — equals
    # config.min_coverage except under auto_min_coverage, where the
    # coverage-adaptive selection may have stepped it down
    min_coverage_used: int = 0


def filter_dist_tuples(
    uhi: np.ndarray, ulo: np.ndarray, counts: np.ndarray, n: int,
    config: KmerRecruitmentConfig,
) -> DistanceEdges:
    """Distance-consistency filter (reference
    distance_based_kmer_recruitment.py:131-149): keep (i, j, d) iff
    count >= min_coverage and count / sum_d'(count(i, j, d')) >= 0.8."""
    if n == 0:
        e = np.empty(0, np.int64)
        return DistanceEdges(dist=np.empty(0, np.int32), i=e, j=e.copy(),
                             freq=e.copy(), unique_kmer_indices=e.copy())
    i_all = uhi[:n].astype(np.int64)
    j_all = (ulo[:n] >> np.uint32(8)).astype(np.int64)
    d_all = (ulo[:n] & np.uint32(0xFF)).astype(np.int64)
    c_all = counts[:n].astype(np.int64)
    # group by (i, j): table sorted by (i, j, d) so groups are contiguous
    pair_key = (i_all << np.int64(24)) | j_all
    starts = np.concatenate([[True], pair_key[1:] != pair_key[:-1]])
    group = np.cumsum(starts) - 1
    all_occ = np.zeros(group[-1] + 1 if n else 0, np.int64)
    np.add.at(all_occ, group, c_all)
    keep = (c_all >= config.min_coverage) & \
        (c_all / np.maximum(all_occ[group], 1) >= config.rel_threshold)
    sel_i = i_all[keep]
    sel_j = j_all[keep]
    uniq = np.unique(np.concatenate([sel_i, sel_j])) if keep.any() \
        else np.empty(0, np.int64)
    return DistanceEdges(
        dist=d_all[keep].astype(np.int32), i=sel_i, j=sel_j,
        freq=c_all[keep], unique_kmer_indices=uniq)


def _rel_fraction(rel: float):
    """(num, den, exact) — an exact small-fraction representation of the
    rel threshold when one exists (the default 0.8 -> 4/5)."""
    fr = Fraction(rel).limit_denominator(64)
    return fr.numerator, fr.denominator, float(fr) == float(rel)


def recruit_unique_kmers(
    clouds_tensor: np.ndarray,
    n_units: np.ndarray,
    rare_codes: np.ndarray,
    config: KmerRecruitmentConfig,
    *,
    capacity: Optional[int] = None,
    entry_chunk: Optional[int] = None,
    dedup_hint: int = 1,
    max_capacity: int = 1 << 27,
    return_edges: bool = True,
    device="cuda",
    mesh=None,
) -> Tuple[np.ndarray, DistanceEdges]:
    """End-to-end: strip-swept distance table -> per-strip ON-DEVICE
    filter -> unique k-mer codes (sorted uint64) + surviving edges.
    The (i, j, d) count table never reaches the host — only the
    surviving edges do, gathered by one index of the kept rows a strip
    (torch knows the kept count there, so no bounded compaction and no
    full-size fallback as in the JAX package). The unique-k-mer SET
    rides a separate on-device endpoint flag array, so
    `return_edges=False` skips the edge readback entirely."""
    if len(rare_codes) >= 1 << 24:
        raise ValueError(
            "rare k-mer table >= 2^24 entries overflows the packed pair key")
    if config.auto_min_coverage and config.min_coverage > 2:
        # Coverage-adaptive edge cutoff. The reference hard-codes
        # min_coverage=4 for its coverage-32 datasets (reference
        # distance_based_kmer_recruitment.py:131-149 and the exposed
        # --min-coverage flag, centroFlye.py:57-60); below ~16x UL the
        # expected count of a TRUE pair edge drops under 4 and the whole
        # stage starves. The d-consistency test (count/all >= 0.8) does
        # not depend on the cutoff, so one sweep at the floor cutoff 2
        # yields the exact edge set of EVERY cutoff in [2, min_coverage]
        # by host-side freq thresholding; pick the largest cutoff whose
        # unique-k-mer yield is not starved (>= auto_min_unique_frac of
        # the rare set).
        base = dataclasses.replace(config, auto_min_coverage=False,
                                   min_coverage=2)
        _, edges2 = recruit_unique_kmers(
            clouds_tensor, n_units, rare_codes, base, capacity=capacity,
            entry_chunk=entry_chunk, dedup_hint=dedup_hint,
            max_capacity=max_capacity, return_edges=True, device=device,
            mesh=mesh)
        n_rare = max(len(rare_codes), 1)
        for c in range(config.min_coverage, 1, -1):
            kept = edges2.freq >= c
            uidx = (np.unique(np.concatenate(
                [edges2.i[kept], edges2.j[kept]]))
                if kept.any() else np.empty(0, np.int64))
            if len(uidx) >= config.auto_min_unique_frac * n_rare:
                break
        if c < config.min_coverage and kept.any() \
                and config.auto_min_degree > 1:
            # endpoint-degree cleanup: at sub-reference cutoffs the edge
            # set admits chance co-occurrences of noise-minted rare
            # k-mers. A TRUE unique k-mer pairs with the unique k-mers
            # of ~2*max_distance other unit copies; a chance pair's
            # endpoints are nearly isolated (degree 1-2). Keeping only
            # endpoints with >= auto_min_degree incident edges removes
            # the noise set without touching the true one.
            deg = np.zeros(len(rare_codes), np.int64)
            np.add.at(deg, edges2.i[kept], 1)
            np.add.at(deg, edges2.j[kept], 1)
            good = deg >= config.auto_min_degree
            kept = kept & good[edges2.i] & good[edges2.j]
            uidx = (np.unique(np.concatenate(
                [edges2.i[kept], edges2.j[kept]]))
                if kept.any() else np.empty(0, np.int64))
        logger.info(
            "auto min_coverage: cutoff %d of [2, %d] (unique %d / rare %d"
            " = %.1f%%, edges %d)", c, config.min_coverage, len(uidx),
            n_rare, 100.0 * len(uidx) / n_rare, int(kept.sum()))
        edges = DistanceEdges(
            dist=edges2.dist[kept], i=edges2.i[kept], j=edges2.j[kept],
            freq=edges2.freq[kept], unique_kmer_indices=uidx,
            min_coverage_used=c)
        return np.sort(rare_codes[uidx]), edges
    if mesh is not None and mesh.size > 1:
        device = mesh.first
    num, den, exact = _rel_fraction(config.rel_threshold)
    n_seen = max(len(rare_codes), 1)
    # the last slot takes the writes that the JAX package drops
    seen = torch.zeros(n_seen + 1, dtype=torch.uint8, device=device)
    args = (config.min_coverage, num, den, config.rel_threshold)
    parts = []
    for keys, cnt, n, _cap in _strip_sweep(
            clouds_tensor, n_units, config, capacity=capacity,
            entry_chunk=entry_chunk, dedup_hint=dedup_hint,
            max_capacity=max_capacity, yield_raw=True, device=device,
            mesh=mesh):
        if n == 0:
            continue
        if cnt is None:
            # RAW strip: counts are run lengths of the sorted pair stream
            seen, keep, cnt = _count_filter_sorted(seen, keys, *args,
                                                   use_frac=exact)
        else:
            seen, keep = _filter_keep_mask(seen, keys, cnt, *args,
                                           use_frac=exact)
        if return_edges:
            edges = _kept_edges(keep, keys, cnt)
            if len(edges[0]):
                parts.append(edges)
        # the sweep builds the next strip while the loop's names still
        # hold this one: free its per-row arrays (peak device memory)
        del keep, cnt
    uniq = np.flatnonzero(seen[:n_seen].cpu().numpy()).astype(np.int64)
    i, j, d, c = (np.concatenate([p[f] for p in parts]) if parts
                  else np.empty(0, np.int64) for f in range(4))
    edges = DistanceEdges(dist=d.astype(np.int32), i=i, j=j, freq=c,
                          unique_kmer_indices=uniq,
                          min_coverage_used=config.min_coverage)
    return np.sort(rare_codes[uniq]), edges
