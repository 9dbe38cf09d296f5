"""Placement scoring on the device, the JAX package's `ops/scoring.py` in
PyTorch.

The reference scores a read against the cloud contig with Python set
intersections per (offset, unit) pair (reference cloud_contig.py:46-76) or
an incremental dict-of-Counters index (:87-95). Here the score of read r
at offset o against contig position o + t of its unit t is

    score1[r, o] = sum_t |cloud(r, t) & contig(o + t)|
    score0[r, o] = sum_t [|cloud(r, t) & contig(o + t)| > 0]

computed either as a bitmap AND and popcount over the unique-k-mer index
space (`placement_scores`; W = ceil(n/32) words a cloud) or as one
one-hot matrix product summed along shifted diagonals
(`placement_scores_matmul`). Both run on the device their inputs are on;
the greedy placement's bulk scoring (stages/placement_fast) and
`device_map_reads` call them. No PyTorch call computes either score, and
the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from centroflye_tpu_torch.ops.myers import words_tensor


def clouds_to_bitmaps(clouds_tensor: np.ndarray, n_kmers: int) -> np.ndarray:
    """(R, T, K) padded index tensor -> (R, T, W) uint32 bitmaps."""
    R, T, K = clouds_tensor.shape
    W = max(1, -(-n_kmers // 32))
    out = np.zeros((R, T, W), dtype=np.uint32)
    idx = clouds_tensor
    r, t, k = np.nonzero(idx >= 0)
    v = idx[r, t, k]
    np.bitwise_or.at(out, (r, t, v // 32),
                     np.uint32(1) << (v % 32).astype(np.uint32))
    return out


def contig_to_bitmap(freq_clouds: Dict[int, set], max_pos: int,
                     n_kmers: int) -> np.ndarray:
    """CloudContig.freq_clouds -> (max_pos+1, W) uint32 bitmap."""
    W = max(1, -(-n_kmers // 32))
    out = np.zeros((max_pos + 1, W), dtype=np.uint32)
    for pos, kmers in freq_clouds.items():
        if pos > max_pos:
            continue
        for v in kmers:
            out[pos, v // 32] |= np.uint32(1) << np.uint32(v % 32)
    return out


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 tensor (SWAR: torch
    has no popcount, and its CPU uint32 lacks +, << and >>)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def placement_scores(read_bitmaps: torch.Tensor, contig_bitmap: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-offset placement scores.

    Args:
      read_bitmaps: (R, T, W) int64 tensor of 32-bit words.
      contig_bitmap: (P, W) int64 tensor of 32-bit words (position
        0..P-1 frequent-k-mer sets), on the same device.

    Returns:
      (score0, score1): each (R, P) int32; offset o scores the read's unit t
      against contig position o + t (positions beyond P contribute nothing).
    """
    R, T, W = read_bitmaps.shape
    P = contig_bitmap.shape[0]
    contig_pad = torch.nn.functional.pad(contig_bitmap, (0, 0, 0, T))
    s0 = torch.zeros((R, P), dtype=torch.int32, device=read_bitmaps.device)
    s1 = torch.zeros_like(s0)
    for t in range(T):
        inter = read_bitmaps[:, t, None, :] & contig_pad[None, t:t + P, :]
        cnt = popcount32(inter).sum(-1, dtype=torch.int32)       # (R, P)
        s1 += cnt
        s0 += cnt > 0
    return s0, s1


def placement_scores_matmul(clouds_tensor: torch.Tensor,
                            contig_kmer: torch.Tensor,
                            contig_pos: torch.Tensor,
                            n_kmers: int, n_pos: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-offset placement scores as one matrix product.

    With A[(r,t), v] the one-hot cloud membership and B[v, p] the one-hot
    contig pair table, C = A @ B gives C[(r,t), p] = |cloud(r,t) &
    contig(p)|, and the offset scores are the shifted-diagonal sums
        score1[r, o] = sum_t C[r, t, o + t]
        score0[r, o] = sum_t [C[r, t, o + t] > 0],
    read through one strided view of C. The counts are exact by
    construction: the operands are float32 0/1 values, exact also when a
    TF32 matmul rounds its inputs to 10 mantissa bits, and the products
    accumulate in float32, exact below 2^24 (a count is at most V). A
    bfloat16 product would round its bfloat16 result above 256.

    Args:
      clouds_tensor: (R, T, K) int32 padded k-mer indices (-1 = pad;
        indices unique within a cloud), on the device to score on.
      contig_kmer / contig_pos: flat (kmer, position) pairs of the contig
        table (unique pairs; positions >= n_pos are ignored), on the same
        device.
      n_kmers: vocabulary size V.
      n_pos: number of contig positions P.

    Returns:
      (score0, score1): each (R, n_pos) int32.
    """
    R, T, K = clouds_tensor.shape
    P = n_pos
    dev = clouds_tensor.device
    flat = clouds_tensor.reshape(R * T, K).long()
    ok = flat >= 0
    A = torch.zeros((R * T, n_kmers), dtype=torch.float32, device=dev)
    A.scatter_add_(1, torch.where(ok, flat, 0), ok.float())
    keep = contig_pos < P
    ck, cp = contig_kmer[keep].long(), contig_pos[keep].long()
    B = torch.zeros((n_kmers, P + T), dtype=torch.float32, device=dev)
    B.index_put_((ck, cp), torch.ones(ck.shape, dtype=torch.float32,
                                      device=dev), accumulate=True)
    C = A @ B                                              # (R*T, P+T)
    # diag[r, t, o] = C[r * T + t, o + t]
    diag = C.as_strided((R, T, P), (T * (P + T), P + T + 1, 1))
    cnt = diag.to(torch.int32)
    return (cnt > 0).sum(1, dtype=torch.int32), cnt.sum(1, dtype=torch.int32)


def device_map_reads(clouds_tensor: np.ndarray, n_units: np.ndarray,
                     freq_clouds: Dict[int, set], max_pos: int,
                     n_kmers: int, threshold=(5, 10),
                     n_contig_clouds: int | None = None, device="cuda"):
    """Re-mapping of all reads against a built contig on `device` — the
    scaled replacement for the reference's map_reads validation pass
    (cloud_contig.py:98-114). Placement rule mirrors map_reads_fast:
    require pos + n_units <= len(contig clouds); score must meet the
    thresholds; rightmost best offset wins.

    Returns {row_index: (pos, score0, score1)}.
    """
    read_bm = words_tensor(clouds_to_bitmaps(clouds_tensor, n_kmers), device)
    contig_bm = words_tensor(contig_to_bitmap(freq_clouds, max_pos, n_kmers),
                             device)
    s0, s1 = placement_scores(read_bm, contig_bm)
    s0 = s0.cpu().numpy()
    s1 = s1.cpu().numpy()
    R, P = s0.shape
    limit = n_contig_clouds if n_contig_clouds is not None else max_pos + 1
    out = {}
    for r in range(R):
        best = (0, 0)
        best_pos = None
        for pos in range(P):
            if pos + int(n_units[r]) > limit:
                continue
            sc = (int(s0[r, pos]), int(s1[r, pos]))
            if sc[0] < threshold[0] or sc[1] < threshold[1]:
                continue
            if sc > best or (sc == best and best_pos is not None
                             and pos > best_pos):
                best = sc
                best_pos = pos
        if best_pos is not None:
            out[r] = (best_pos, best[0], best[1])
    return out
