"""Plain reference of read recruitment (the reference rr's semantics,
rr.cpp:41-90): a read is recruited when the unit, or its reverse
complement, aligns to it in HW mode (free start and end in the read)
within the threshold; recruited reads are written in input order.

The edit distance is the textbook dynamic programme, one query row at a
time over whole reads, in plain PyTorch. With E_i[j] = D_i[j] - j, row i
is a running minimum:

    Y[0] = i,  Y[j] = min(E_{i-1}[j-1] + cost(i, j) - 1, E_{i-1}[j] + 1)
    E_i = cummin(Y)

where cost is 0 for a match of two bases (A, C, G, T) and 1 otherwise,
and the HW start row is D_0 = 0. A read's distance is the least D_m over
its columns, and m for the empty alignment. Imports numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

PAD = 4
COMP = np.array([3, 2, 1, 0, 4], np.int8)
CELLS_PER_BLOCK = 1 << 25       # reads x columns held at once


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[codes][::-1]


def _block_hw(query: np.ndarray, texts: list, device) -> np.ndarray:
    """HW distances of `query` against each text of one block."""
    n, L = len(texts), max(t.size for t in texts)
    T = torch.full((n, L), PAD, dtype=torch.int8)
    lens = torch.zeros(n, dtype=torch.int64)
    for r, t in enumerate(texts):
        T[r, :t.size] = torch.from_numpy(np.ascontiguousarray(t))
        lens[r] = t.size
    T = T.to(device)
    # cost - 1 by query base: -1 on a match, 0 otherwise (N matches nothing)
    cm1 = torch.stack([-(T == b).to(torch.int32) for b in range(4)]
                      + [torch.zeros((n, L), dtype=torch.int32,
                                     device=device)])
    ar = torch.arange(L + 1, device=device, dtype=torch.int32)
    E = (-ar).expand(n, L + 1).contiguous()             # D_0 = 0
    Y = torch.empty_like(E)
    idx = torch.empty((n, L + 1), dtype=torch.int64, device=device)
    for i, q in enumerate(query.tolist(), start=1):
        a = E[:, :-1] + cm1[q if 0 <= q < 4 else PAD]
        torch.minimum(a, E[:, 1:] + 1, out=Y[:, 1:])
        Y[:, 0] = i
        torch.cummin(Y, dim=1, out=(E, idx))
    m = query.size
    D = (E[:, 1:] + ar[1:]).to(torch.int64)
    cols = torch.arange(L, device=device)[None, :]
    D = torch.where(cols < lens.to(device)[:, None], D, m)
    return torch.clamp(D.min(dim=1).values, max=m).cpu().numpy()


def hw_distances(query: np.ndarray, texts: list, device) -> np.ndarray:
    """HW distance of `query` (int8 codes) against every text (int8 codes),
    in blocks of similar lengths."""
    out = np.zeros(len(texts), np.int64)
    order = np.argsort([t.size for t in texts], kind="stable")
    i = 0
    while i < len(order):
        j = i + 1
        while j < len(order) and (j - i + 1) * texts[order[j]].size \
                <= CELLS_PER_BLOCK:
            j += 1
        blk = order[i:j]
        out[blk] = _block_hw(query, [texts[k] for k in blk], device)
        i = j
    return out


def recruited(unit: np.ndarray, texts: list, threshold: int, device,
              strands=("fwd", "rc")) -> np.ndarray:
    """Whether each text is recruited: the least HW distance over the
    `strands` of the unit is within the threshold."""
    best = np.full(len(texts), np.iinfo(np.int64).max, np.int64)
    for s in strands:
        q = unit if s == "fwd" else revcomp(unit)
        best = np.minimum(best, hw_distances(q, texts, device))
    return best <= threshold
