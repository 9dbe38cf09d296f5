"""Fused recruitment step: packed upload -> seed filter -> compaction ->
two-strand Myers on the survivors, one device call per candidate batch.

Counterpart of the JAX package's `ops/fused_recruit.py`: the host uploads
base codes packed 4 per byte (plus an N bitmask, 8 per byte, when a row
holds an in-range N); the device counts sampled unit seed hits, moves the
passing rows to the front (stable argsort of the fail flag) and scores
the passing rows among the first `k_budget`, sentinel m for the others.
The host receives one bundled int32 array [df | dr | hits | n_pass] and
handles n_pass > k_budget (overflow) itself.

The scorer differs by device and gives the same bundle:
- on the card, one launch of `ops/myers_cuda.myers_hw_chunks` reads the
  packed rows in place and scores only the passing rows, each in column
  chunks side by side, straight into the bundle; n_pass stays on the card;
- on the CPU, the first `k_budget` rows of the order are unpacked and
  scored whole (`ops/myers_cuda.recruit_distances`, the plain version),
  and the distances scattered back to row order.

Two filter paths, as in the JAX package:
- packed (no mask, an LE-keyed bitmap, seed_k <= 16, stride 1/2/4): seed
  codes come straight from the packed words and only the survivors are
  unpacked;
- unpacked (an N mask, or the other settings): the batch is unpacked and
  counted by `ops/seed_filter.seed_hit_counts_bitmap`.

The glue is plain PyTorch on either device; the survivor scorer is the
only kernel.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from centroflye_tpu_torch.ops.myers import MASK, int32_words
from centroflye_tpu_torch.ops.myers_cuda import (myers_hw_chunks,
                                                 recruit_distances)
from centroflye_tpu_torch.ops.seed_filter import seed_hit_counts_bitmap
from centroflye_tpu_torch.parallel.mesh import Mesh, replicate, shard_batch


def unpack_2bit_host(packed: np.ndarray) -> np.ndarray:
    """Host (numpy) inverse of pack_2bit for N-free rows: (B, L/4) uint8
    -> (B, L) int8 base codes, for overflow rows that re-enter the exact
    Myers tier as codes."""
    B, Lq = packed.shape
    out = np.empty((B, Lq * 4), np.int8)
    for i in range(4):
        out[:, i::4] = (packed >> (2 * i)) & 3
    return out


def pack_2bit(codes: np.ndarray, lens: Optional[np.ndarray] = None,
              ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(B, L) int8 base codes -> (packed (B, L/4) uint8, n_mask (B, L/8)
    uint8 or None). L must be a multiple of 8. PAD/N positions are marked
    in n_mask and packed as base 0; n_mask is None when no N/PAD lies in
    range (positions at or past `lens` are don't-care)."""
    B, L = codes.shape
    assert L % 8 == 0
    is_n = codes >= 4
    vals = np.where(is_n, 0, codes).astype(np.uint8)
    v = vals.reshape(B, L // 4, 4)
    packed = (v[:, :, 0] | (v[:, :, 1] << 2) | (v[:, :, 2] << 4)
              | (v[:, :, 3] << 6))
    if lens is not None:
        # the seed filter drops windows crossing the length boundary and
        # the Myers kernels stop at len: only in-range N needs the mask
        is_n = is_n & (np.arange(L, dtype=np.int32)[None, :]
                       < np.asarray(lens, np.int32)[:, None])
    if not is_n.any():
        return packed.astype(np.uint8), None
    nm = is_n.reshape(B, L // 8, 8).astype(np.uint8)
    n_mask = np.zeros((B, L // 8), np.uint8)
    for b in range(8):
        n_mask |= nm[:, :, b] << b
    return packed.astype(np.uint8), n_mask


def _unpack_nomask(packed: torch.Tensor) -> torch.Tensor:
    """Device inverse of pack_2bit for rows with no in-range N."""
    B, Lq = packed.shape
    parts = [((packed >> (2 * i)) & 3).to(torch.int8) for i in range(4)]
    return torch.stack(parts, dim=-1).reshape(B, Lq * 4)


def _unpack_2bit(packed: torch.Tensor, n_mask: torch.Tensor) -> torch.Tensor:
    """Device inverse of pack_2bit -> (B, L) int8, N/PAD as 4."""
    B, Lq = packed.shape
    bits = [((n_mask >> i) & 1).to(torch.bool) for i in range(8)]
    is_n = torch.stack(bits, dim=-1).reshape(B, Lq * 4)
    return torch.where(is_n, 4, _unpack_nomask(packed))


def make_fused_recruit(seed_bitmap: torch.Tensor,
                       peq_fwd: torch.Tensor, peq_rc: torch.Tensor,
                       *, m: int, seed_k: int, min_hits: int,
                       k_budget: int = 128, stride: int = 2,
                       seed_bitmap_le: Optional[torch.Tensor] = None,
                       mesh=None):
    """Returns fused(packed, n_mask, lens) -> (df, dr, hits, n_pass) on the
    device of peq_fwd. seed_bitmap: the membership bitmap
    (ops/seed_filter.build_seed_bitmap) as an int64 tensor of 32-bit
    words; seed_bitmap_le, the same LE-keyed (build_seed_bitmap(le=True)),
    enables the packed filter path. Positions are sampled every `stride`.
    `min_hits` is in stride-1 units and scaled down here so the sampled
    filter keeps the config's strictness.

    mesh: a `parallel/mesh.Mesh` of more than one device shards the
    batch's rows over it (rows must be a multiple of its size); without
    one, the step is the one shard of peq_fwd's device. Each shard runs
    the whole body, K1 included, on its device with its own copy of the
    tables, and the bundle is shard-blocked [df|dr|hits|n_pass] a shard
    on the mesh's first device, which `unbundle` re-orders as the JAX
    package's engine does (n_pass: the largest shard's; the host
    overflow rule then applies per shard)."""
    min_hits = max(1, min_hits // stride)
    # the packed filter reads a k-mer from one u32 word pair (k <= 16) at
    # in-word offsets that tile the word evenly
    packed_path_ok = (seed_bitmap_le is not None and seed_k <= 16
                      and stride in (1, 2, 4))
    body = functools.partial(
        _fused_body, m=m, seed_k=seed_k, min_hits=min_hits,
        k_budget=k_budget, stride=stride, packed_path_ok=packed_path_ok)
    if mesh is None or mesh.size <= 1:
        mesh = Mesh([peq_fwd.device])
    n_dev = mesh.size
    per_device = list(zip(*(
        replicate(mesh, t) if t is not None else (None,) * n_dev
        for t in (seed_bitmap, peq_fwd, peq_rc, seed_bitmap_le,
                  int32_words(peq_fwd), int32_words(peq_rc)))))

    def fused_raw(packed, n_mask, lens):
        """Returns the bundle without waiting for it: the shards' blocks
        [df, dr, hits, n_pass(1)] on the first device. packed (B, L/4)
        uint8, n_mask (B, L/8) uint8 or None, and lens (B,) int32: numpy
        arrays or tensors."""
        arrays = [packed, lens] + ([n_mask] if n_mask is not None else [])
        parts = [body(per_device[i], sh[0], sh[2] if len(sh) > 2 else None,
                      sh[1]).to(mesh.first)
                 for i, sh in enumerate(shard_batch(mesh, *arrays))]
        return torch.cat(parts) if n_dev > 1 else parts[0]

    def unbundle(out: np.ndarray, B: int):
        """-> (df, dr, hits, n_pass); sharded, n_pass is the largest
        shard's."""
        blocks = out.reshape(n_dev, -1)
        Bs = B // n_dev
        return (blocks[:, :Bs].reshape(B), blocks[:, Bs:2 * Bs].reshape(B),
                blocks[:, 2 * Bs:3 * Bs].reshape(B),
                int(blocks[:, 3 * Bs].max()))

    def fused_unbundled(packed, n_mask, lens):
        out = fused_raw(packed, n_mask, lens).cpu().numpy()
        return unbundle(out, lens.shape[0])

    fused_unbundled.raw = fused_raw
    fused_unbundled.unbundle = unbundle
    fused_unbundled.min_hits = min_hits      # in sampled-position units
    fused_unbundled.stride = stride
    fused_unbundled.n_dev = n_dev
    return fused_unbundled


def score_chunked(words_f, words_r, packed, n_mask, lens, hits, *, m: int,
                  min_hits: int, k_budget: int) -> torch.Tensor:
    """The card's survivor scoring: the bundle [df, dr, hits, n_pass] of
    one shard from its hit counts (words_f, words_r: the unit's and its
    reverse complement's peqs as int32 words), with df and dr from one
    `myers_hw_chunks` launch over the passing rows among the first
    k_budget of the pass order, m elsewhere; nothing is read back. On CPU
    tensors the launch is the kernel's plain version."""
    B = hits.shape[0]
    fail = hits < min_hits
    order = torch.argsort(fail.to(torch.int32), stable=True)  # pass first
    n_pass = (~fail).sum(dtype=torch.int32).reshape(1)
    out = torch.cat([torch.full((2 * B,), m, dtype=torch.int32,
                                device=hits.device), hits, n_pass])
    myers_hw_chunks(words_f, words_r, packed, n_mask, lens.to(torch.int32),
                    order[:k_budget], out[3 * B:], out[:B], out[B:2 * B],
                    m=m)
    return out


def _fused_body(tables, packed, n_mask, lens, *, m, seed_k, min_hits,
                k_budget, stride, packed_path_ok):
    """One device's fused step on its own tables (seed_bitmap, peq_fwd,
    peq_rc, seed_bitmap_le, and the peqs as int32 words) and rows -> the
    bundle [df, dr, hits, n_pass]."""
    seed_bitmap, peq_fwd, peq_rc, seed_bitmap_le, words_f, words_r = tables
    kmask = (1 << (2 * seed_k)) - 1

    def packed_hits(W, Wn, lens, offsets):
        """Hit counts over sampled in-word phases `offsets`: W/Wn are
        (R, nw) words of 16 bases each (base 16w+j at bits 2j); a window
        at in-word offset o spans W[w] and W[w+1]."""
        nw = W.shape[1]
        pos16 = 16 * torch.arange(nw, device=W.device)[None, :]
        hits = torch.zeros((W.shape[0],), dtype=torch.int32, device=W.device)
        for o in offsets:
            code = W >> (2 * o)
            if o > 0:
                code = code | (Wn << (32 - 2 * o))
            code = code & kmask
            valid = (pos16 + (o + seed_k)) <= lens[:, None]
            word = torch.where(valid, code >> 5, 0)
            got = seed_bitmap_le[word]
            found = (((got >> (code & 31)) & 1) == 1) & valid
            hits += found.sum(dim=1, dtype=torch.int32)
        return hits

    def score_survivors(hits, survivor_codes):
        """Compaction, scoring and scatter shared by both filter paths:
        survivor_codes(top) gives the (kb, L) int8 codes of rows `top`.
        On the card, `score_chunked` on the packed rows instead."""
        if hits.device.type == "cuda":
            return score_chunked(words_f, words_r, packed, n_mask, lens, hits,
                                 m=m, min_hits=min_hits, k_budget=k_budget)
        B = hits.shape[0]
        fail = hits < min_hits
        order = torch.argsort(fail.to(torch.int32), stable=True)  # pass first
        top = order[:min(k_budget, B)]
        dist_f, dist_r = recruit_distances(peq_fwd, peq_rc,
                                           survivor_codes(top), lens[top],
                                           m=m)
        sub_ok = ~fail[top]
        df = torch.full((B,), m, dtype=torch.int32, device=hits.device)
        dr = df.clone()
        df[top] = torch.where(sub_ok, dist_f, m)
        dr[top] = torch.where(sub_ok, dist_r, m)
        n_pass = (~fail).sum(dtype=torch.int32).reshape(1)
        return torch.cat([df, dr, hits, n_pass])

    if n_mask is None and packed_path_ok:
        B, Lq = packed.shape
        if Lq % 4:
            raise ValueError(f"packed rows of {Lq} bytes: the segment "
                             f"length must be a multiple of 16")
        W = packed.view(torch.int32).to(torch.int64) & MASK
        Wn = torch.nn.functional.pad(W[:, 1:], (0, 1))  # next word, 0-padded
        hits = packed_hits(W, Wn, lens, range(0, 16, stride))
        return score_survivors(                       # unpack kb rows only
            hits, lambda top: _unpack_nomask(packed[top]))
    codes = (_unpack_nomask(packed) if n_mask is None
             else _unpack_2bit(packed, n_mask))
    hits = seed_hit_counts_bitmap(seed_bitmap, codes, lens, k=seed_k,
                                  stride=stride)
    return score_survivors(hits, lambda top: codes[top])
