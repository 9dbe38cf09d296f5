"""Fused recruitment step: packed upload -> seed filter -> compaction ->
two-strand Myers on the survivors, one device call per candidate batch.

Counterpart of the JAX package's `ops/fused_recruit.py` on the no-N packed
path (`_fused_body_packed`): the host uploads base codes packed 4 per
byte; the device counts sampled unit seed hits straight from the packed
words, moves the passing rows to the front (stable argsort of the fail
flag), unpacks and scores only the first `k_budget` rows with
`ops/myers_cuda.recruit_distances` (the CUDA kernel on the card), and
scatters the distances back to row order, sentinel m for filtered rows.
The host receives one bundled int32 array [df | dr | hits | n_pass] and
handles n_pass > k_budget (overflow) itself.

The glue is plain PyTorch on either device; the survivor scorer is the
only kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from centroflye_tpu_torch.ops.myers import MASK
from centroflye_tpu_torch.ops.myers_cuda import recruit_distances


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


def make_fused_recruit(seed_bitmap_le: torch.Tensor,
                       peq_fwd: torch.Tensor, peq_rc: torch.Tensor,
                       *, m: int, seed_k: int, min_hits: int,
                       k_budget: int = 128, stride: int = 2):
    """Returns fused(packed, n_mask, lens) -> (df, dr, hits, n_pass) on the
    device of peq_fwd. seed_bitmap_le: the LE-keyed membership bitmap
    (ops/seed_filter.build_seed_bitmap(le=True)) as an int64 tensor of
    32-bit words; positions are sampled every `stride`. `min_hits` is in
    stride-1 units and scaled down here so the sampled filter keeps the
    config's strictness."""
    if seed_k > 16 or stride not in (1, 2, 4):
        # the packed filter reads a k-mer from one u32 word pair
        raise NotImplementedError(
            "only the packed filter path (seed_k <= 16, stride 1/2/4) is "
            "ported (ROADMAP Queue 1: masked fused path)")
    min_hits = max(1, min_hits // stride)
    device = peq_fwd.device
    kmask = (1 << (2 * seed_k)) - 1

    def _packed_hits(W, Wn, lens, offsets):
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

    def _fused_body_packed(packed, lens):
        B, Lq = packed.shape
        if Lq % 4:
            raise ValueError(f"packed rows of {Lq} bytes: the segment "
                             f"length must be a multiple of 16")
        W = packed.view(torch.int32).to(torch.int64) & MASK
        Wn = torch.nn.functional.pad(W[:, 1:], (0, 1))  # next word, 0-padded
        hits = _packed_hits(W, Wn, lens, range(0, 16, stride))
        fail = hits < min_hits
        order = torch.argsort(fail.to(torch.int32), stable=True)  # pass first
        top = order[:min(k_budget, B)]
        sub_codes = _unpack_nomask(packed[top])      # unpack kb rows only
        dist_f, dist_r = recruit_distances(peq_fwd, peq_rc, sub_codes,
                                           lens[top], m=m)
        sub_ok = ~fail[top]
        df = torch.full((B,), m, dtype=torch.int32, device=packed.device)
        dr = df.clone()
        df[top] = torch.where(sub_ok, dist_f, m)
        dr[top] = torch.where(sub_ok, dist_r, m)
        n_pass = (~fail).sum(dtype=torch.int32).reshape(1)
        return torch.cat([df, dr, hits, n_pass])

    def fused_raw(packed, n_mask, lens):
        """Returns the bundled device tensor [df(B), dr(B), hits(B),
        n_pass(1)] without waiting for it. packed (B, L/4) uint8 and lens
        (B,) int32 numpy arrays or tensors."""
        if n_mask is not None:
            raise NotImplementedError(
                "the N-masked fused path is not ported (ROADMAP Queue 1: "
                "masked fused path with seed_hit_counts_bitmap)")
        packed = torch.as_tensor(packed).to(device)
        lens = torch.as_tensor(lens).to(device)
        return _fused_body_packed(packed, lens)

    def unbundle(out: np.ndarray, B: int):
        """-> (df, dr, hits, n_pass)."""
        return out[:B], out[B:2 * B], out[2 * B:3 * B], int(out[3 * B])

    def fused_unbundled(packed, n_mask, lens):
        out = fused_raw(packed, n_mask, lens).cpu().numpy()
        return unbundle(out, lens.shape[0])

    fused_unbundled.raw = fused_raw
    fused_unbundled.unbundle = unbundle
    fused_unbundled.min_hits = min_hits      # in sampled-position units
    fused_unbundled.stride = stride
    return fused_unbundled
