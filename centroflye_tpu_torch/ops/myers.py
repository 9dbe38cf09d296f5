"""Batched Myers bit-parallel edit distance in plain PyTorch.

Counterpart of the JAX package's `ops/myers.py::myers_distance_batch`, and
the plain version that the CUDA kernel of `ops/myers_cuda.py` is held
against. The query's bit state is W = ceil(m/32) 32-bit words per row,
and a batch of B rows advances in lock-step, one (B, W) column update per
text column.

Words are held in int64 and masked to 32 bits after every add, NOT and
shift: PyTorch's CPU backend has no `+`, `~`, `<<`, `>>` or `<` on
uint32. The multiword carry of the Myers addition is a Kogge-Stone
carry-lookahead over the word axis, log2(W) steps.

Covered: modes HW (infix), SHW (prefix) and NW (global); one shared
(5, W) query or per-row (B, 5, W) queries with per-row lengths `ms`;
collect="best" (distance and end) or "all" (the score after each column).
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

WORD = 32
MASK = 0xFFFFFFFF


def n_words(m: int) -> int:
    return (m + WORD - 1) // WORD


def build_peq(query_codes: np.ndarray, m: int | None = None) -> np.ndarray:
    """Peq bit table for a query: (5, W) uint32; row a has bit i set iff
    query[i] == a. Row 4 (PAD/N) is all zeros (mismatches everything).
    Word w holds query rows 32w..32w+31, little-endian."""
    query_codes = np.asarray(query_codes)
    if m is None:
        m = len(query_codes)
    W = n_words(m)
    peq = np.zeros((5, W), dtype=np.uint32)
    for i in range(min(m, len(query_codes))):
        a = int(query_codes[i])
        if 0 <= a < 4:
            peq[a, i // WORD] |= np.uint32(1) << np.uint32(i % WORD)
    return peq


def words_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words (a peq table, a bitmap) -> int64 tensor of
    32-bit words, the port's word type, on `device`."""
    return torch.from_numpy(np.asarray(words, np.uint32).astype(np.int64)
                            ).to(device)


def _shift_words(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[..., w - d] at word w, 0 below d (toward the higher word)."""
    return torch.nn.functional.pad(x[..., :-d], (d, 0))


def _carry_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Multi-word a + b over little-endian 32-bit words (..., W); carries
    propagated by a Kogge-Stone generate/propagate prefix."""
    s = a + b
    g = s >> WORD                 # carry generated out of this word
    s = s & MASK
    p = (s == MASK).to(s.dtype)   # carry would propagate through this word
    d = 1
    while d < s.shape[-1]:
        g = g | (p & _shift_words(g, d))
        p = p & _shift_words(p, d)
        d *= 2
    return (s + _shift_words(g, 1)) & MASK


def _shift_left1(x: torch.Tensor, carry_bit: int) -> torch.Tensor:
    """(x << 1) across word boundaries, `carry_bit` into bit 0 of word 0."""
    shifted_in = _shift_words(x >> (WORD - 1), 1)
    shifted_in[..., 0] = carry_bit
    return ((x << 1) & MASK) | shifted_in


def myers_column_update(eq, vp, vn, *, global_mode: bool):
    """One Myers column update. Returns (vp, vn, hp, hn); the caller reads
    the score change at the query's last row from hp/hn before the shift.
    global_mode=True shifts a 1 into hp (NW/SHW top boundary); False is
    HW search mode (free start in the text)."""
    d0 = (_carry_add(eq & vp, vp) ^ vp) | eq | vn
    hp = vn | (~(d0 | vp) & MASK)
    hn = vp & d0
    hp_s = _shift_left1(hp, 1 if global_mode else 0)
    hn_s = _shift_left1(hn, 0)
    vp_new = hn_s | (~(d0 | hp_s) & MASK)
    vn_new = hp_s & d0
    return vp_new, vn_new, hp, hn


def myers_distance_batch(
    peq: torch.Tensor,
    text: torch.Tensor,
    lens: torch.Tensor,
    *,
    m: int,
    mode: Literal["HW", "SHW", "NW"] = "HW",
    collect: Literal["best", "all"] = "best",
    ms: torch.Tensor | None = None,
):
    """Edit distance of one (or per-row) query against a batch of targets.

    Args:
      peq: (5, W) int64 query table of 32-bit words (`words_tensor`), or
        (B, 5, W) per-row queries.
      text: (B, L) int8 target codes (0..3 bases, 4 = N/PAD).
      lens: (B,) int32 actual target lengths.
      m: query length (the widest, with per-row queries).
      mode: "HW" infix / "SHW" prefix / "NW" global (edlib.h:21-47).
      collect: "best" -> dist and end per row, where end is the 0-based
        index of the last aligned target char (first column achieving the
        min; -1 when the empty alignment m is the min or mode="NW").
        "all" -> the (B, L) int32 score at the query's last row after
        each column; masked columns repeat the previous score.
      ms: optional (B,) per-row query lengths, each in [1, m]; the score
        is then tracked at each row's own last query row. Peq rows at and
        above ms[b] must be zero bits.

    Returns:
      dict with "dist" (B,) int32 and "end" (B,) int32, or "scores"
      (B, L) int32, on text's device.
    """
    B, L = text.shape
    W = n_words(m)
    dev = text.device
    peq = peq.to(device=dev, dtype=torch.int64)
    per_row_query = peq.dim() == 3
    if peq.shape != ((B, 5, W) if per_row_query else (5, W)):
        raise ValueError(f"peq shape {tuple(peq.shape)} != (5, {W}) or "
                         f"({B}, 5, {W})")
    global_mode = mode in ("SHW", "NW")
    if ms is None:
        m_rows = torch.full((B,), m, dtype=torch.int64, device=dev)
    else:
        m_rows = ms.reshape(-1).to(device=dev, dtype=torch.int64)
        if B and not bool(((m_rows >= 1) & (m_rows <= m)).all()):
            raise ValueError(f"ms must lie in [1, {m}]")
    hw_word = ((m_rows - 1) // WORD)[:, None]         # (B, 1): tap word
    hb = (m_rows - 1) % WORD                          # (B,): tap bit
    lens = lens.reshape(-1).to(device=dev, dtype=torch.int64)
    rows = torch.arange(B, device=dev)

    idx = text.to(torch.int64)
    idx = torch.where((idx >= 0) & (idx < 4), idx, 4)   # N/PAD: zero row
    vp = torch.full((B, W), MASK, dtype=torch.int64, device=dev)
    vn = torch.zeros((B, W), dtype=torch.int64, device=dev)
    score = m_rows.clone()
    best = score.clone()
    final = score.clone()
    end = torch.full((B,), -1, dtype=torch.int64, device=dev)
    scores = (torch.empty((B, L), dtype=torch.int32, device=dev)
              if collect == "all" else None)

    # columns at or past every row's length change nothing
    n_cols = min(L, int(lens.max())) if B else 0
    for j in range(n_cols):
        active = j < lens
        eq = peq[rows, idx[:, j]] if per_row_query else peq[idx[:, j]]
        vp_new, vn_new, hp, hn = myers_column_update(
            eq, vp, vn, global_mode=global_mode)
        hp_w = hp.gather(1, hw_word)[:, 0]
        hn_w = hn.gather(1, hw_word)[:, 0]
        inc = ((hp_w >> hb) & 1) - ((hn_w >> hb) & 1)
        sel = active[:, None]
        vp = torch.where(sel, vp_new, vp)
        vn = torch.where(sel, vn_new, vn)
        score = torch.where(active, score + inc, score)
        improved = active & (score < best)
        best = torch.where(improved, score, best)
        end = torch.where(improved, j, end)
        final = torch.where(active & (j == lens - 1), score, final)
        if scores is not None:
            scores[:, j] = score

    if scores is not None:
        scores[:, n_cols:] = score[:, None]
        return {"scores": scores}
    if mode == "NW":
        return {"dist": final.to(torch.int32),
                "end": (lens - 1).to(torch.int32)}
    return {"dist": best.to(torch.int32), "end": end.to(torch.int32)}


def edit_distance_oracle(query: str, text: str, mode: str = "HW"):
    """O(mn) DP oracle (host numpy) for tests, as the JAX package's.

    Returns (dist, end) with the semantics of myers_distance_batch
    "best": end is the 0-based index of the last aligned target char, the
    first column achieving the minimum; -1 if the empty prefix is best.
    """
    from centroflye_tpu_torch.io.encoding import encode

    q = encode(query)
    t = encode(text)
    m, n = len(q), len(t)
    prev = np.arange(m + 1, dtype=np.int64)  # column for empty target prefix
    best, end = m, -1
    for j in range(n):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = 0 if mode == "HW" else j + 1
        for i in range(1, m + 1):
            sub = prev[i - 1] + (0 if (q[i - 1] == t[j] and q[i - 1] < 4)
                                 else 1)
            cur[i] = min(sub, prev[i] + 1, cur[i - 1] + 1)
        if cur[m] < best:
            best, end = int(cur[m]), j
        prev = cur
    if mode == "NW":
        return int(prev[m]), n - 1
    return best, end
