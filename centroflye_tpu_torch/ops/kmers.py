"""Device k-mer primitives in plain PyTorch: the JAX package's
`ops/kmers.py`, so far `pack_kmers` and `lookup_codes`.

A k-mer (k <= 31) is a big-endian 2-bit code carried as a (hi, lo) pair of
32-bit words, held in int64 tensors (the port's word type: torch on the
CPU has no uint32 shifts). Invalid windows carry the SENTINEL pair, which
sorts last. Everything here is exact.
"""

from __future__ import annotations

import math

import torch

from centroflye_tpu_torch.ops.myers import MASK

SENTINEL = 0xFFFFFFFF


def pack_kmers(codes: torch.Tensor, lens: torch.Tensor, *, k: int):
    """All k-mer windows of a padded batch of base codes.

    Args:
      codes: (B, L) int8 base codes (0..3; >= 4 is N/PAD).
      lens: (B,) int32 sequence lengths.
      k: k-mer length, 2 <= k <= 31.

    Returns:
      (hi, lo, valid), each (B, L-k+1): hi/lo int64 32-bit words, valid
      bool marks windows inside the sequence and free of N/PAD. Invalid
      windows hold the SENTINEL pair.
    """
    B, L = codes.shape
    nwin = max(L - k + 1, 0)
    dev = codes.device
    ok = codes < 4
    vals = torch.where(ok, codes, 0).to(torch.int64) & MASK
    hi = torch.zeros((B, nwin), dtype=torch.int64, device=dev)
    lo = torch.zeros((B, nwin), dtype=torch.int64, device=dev)
    for i in range(k):
        v = vals[:, i:i + nwin]
        s = 2 * (k - 1 - i)
        if s >= 32:
            hi = hi | ((v << (s - 32)) & MASK)
        else:
            lo = lo | ((v << s) & MASK)
    # valid: all k bases ok and the window's end within len
    cs = torch.nn.functional.pad(torch.cumsum((~ok).to(torch.int32), dim=1),
                                 (1, 0))
    clean = (cs[:, k:] - cs[:, :nwin]) == 0
    pos = torch.arange(nwin, device=dev)[None, :]
    inside = pos + k <= lens.to(device=dev, dtype=torch.int64)[:, None]
    valid = clean & inside
    hi = torch.where(valid, hi, SENTINEL)
    lo = torch.where(valid, lo, SENTINEL)
    return hi, lo, valid


def lookup_codes(table_hi: torch.Tensor, table_lo: torch.Tensor,
                 hi: torch.Tensor, lo: torch.Tensor):
    """Binary-search membership of (hi, lo) codes in a sorted
    SENTINEL-padded table, branchless as in the JAX package. Returns
    (found bool, index int32) per query; index is valid only where found.

    As in the JAX package, table reads clamp to the last entry (JAX's
    gather does): a search that ends early can step past the end, and
    then a query equal to the last entry is found with index n, not n-1
    (ROADMAP Queue 3)."""
    n = table_hi.shape[0]
    lo_i = torch.zeros(hi.shape, dtype=torch.int64, device=hi.device)
    hi_i = torch.full(hi.shape, n, dtype=torch.int64, device=hi.device)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        mid = (lo_i + hi_i) // 2
        at = mid.clamp(max=n - 1)
        t_hi, t_lo = table_hi[at], table_lo[at]
        go_right = (t_hi < hi) | ((t_hi == hi) & (t_lo <= lo))
        lo_i = torch.where(go_right, mid + 1, lo_i)
        hi_i = torch.where(go_right, hi_i, mid)
    idx = torch.clamp(lo_i - 1, min=0)
    at = idx.clamp(max=n - 1)
    found = ((table_hi[at] == hi) & (table_lo[at] == lo)
             & (hi != SENTINEL))
    return found, idx.to(torch.int32)
