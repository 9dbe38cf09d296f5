"""Plain reference of the monomer decomposition: each read becomes a chain
of monomer calls (symbol, start, end, reliability), the semantics of the
port's lockstep decomposer and of the JAX package's, rebuilt here from
the configuration alone.

A read's chain starts at 0. At each position with at least
min_tail = int(mean monomer length / 2) bases left, the window of
max_m + slack bases there is aligned to every monomer on both strands
(2n queries; symbol q < n forward, n + q its reverse complement):
- the first call (HW, free start): each query's score at every column;
  the call is the earliest column that is a local minimum of the best
  score over length among the queries and lies within 0.05 of its least,
  and there the query of least score over length; the call ends at that
  column and starts max(pos, end - length);
- every later call (SHW, anchored start, free end): each query's least
  score over the window's columns and the first column reaching it (none
  if nothing beats the empty alignment, m); the query of least score over
  length, the first on ties; the call spans pos to that column.
A call that reaches no column is a gap of one monomer's length. A call
is reliable ('+') unless a gap or its score exceeds max_divergence x the
monomer's length. The next call starts where this one ends.

The edit distances are the textbook programme, one query row at a time,
over every (query, window) pair of a step at once, as in
`reference/recruit_file.py` (E_i[j] = D_i[j] - j, a running minimum), in
plain PyTorch. Imports numpy and torch only.
"""

from __future__ import annotations

import numpy as np
import torch

PAD = 4
COMP = np.array([3, 2, 1, 0, 4], np.int8)
ENC = np.full(256, PAD, np.int8)
for _i, _c in enumerate(b"ACGT"):
    ENC[_c] = _i
    ENC[_c + 32] = _i
TOL = 0.05


def encode(seq) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return seq.astype(np.int8)
    return ENC[np.frombuffer(seq.encode("ascii"), np.uint8)]


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[codes][::-1]


class Queries:
    def __init__(self, monomers: dict, strands, device):
        seqs = [encode(s) for s in monomers.values()]
        if "rc" in strands:
            seqs = seqs + [revcomp(s) for s in seqs]
        self.ms = np.array([s.size for s in seqs], np.int64)
        self.max_m = int(self.ms.max())
        codes = np.full((len(seqs), self.max_m), PAD, np.int8)
        for q, s in enumerate(seqs):
            codes[q, :s.size] = s
        self.codes = torch.from_numpy(codes.astype(np.int64)).to(device)
        self.mean_len = float(np.mean([len(s) for s in monomers.values()]))
        self.device = device


def _last_rows_body(Qs: Queries, W: torch.Tensor, mode: str, sels: dict,
                    out: torch.Tensor):
    """Fills out (Q, R, L) with D at each query's last row."""
    dev = W.device
    R, L = W.shape
    Q = Qs.ms.size
    cm1 = torch.stack([-(W == b).to(torch.int32) for b in range(4)]
                      + [torch.zeros((R, L), dtype=torch.int32,
                                     device=dev)])           # (5, R, L)
    ar = torch.arange(L + 1, device=dev, dtype=torch.int32)
    if mode == "SHW":
        E = torch.zeros((Q, R, L + 1), dtype=torch.int32, device=dev)
    else:
        E = (-ar).expand(Q, R, L + 1).contiguous()
    Y = torch.empty_like(E)
    idx = torch.empty((Q, R, L + 1), dtype=torch.int64, device=dev)
    for i in range(1, Qs.max_m + 1):
        cost = cm1[Qs.codes[:, i - 1]]                    # (Q, R, L)
        torch.minimum(E[:, :, :-1] + cost, E[:, :, 1:] + 1,
                      out=Y[:, :, 1:])
        Y[:, :, 0] = i
        torch.cummin(Y, dim=2, out=(E, idx))
        if i in sels:
            out[sels[i]] = E[sels[i], :, 1:] + ar[1:]


class LastRows:
    """D at each query's last row over every column of R windows of L
    codes: (Q, R, L) int32 on the device. mode "HW" starts D_0 = 0,
    "SHW" D_0[j] = j. On a card the step's launches are captured once in
    a CUDA graph and replayed for each step's windows."""

    def __init__(self, Qs: Queries, R: int, L: int, mode: str):
        dev = torch.device(Qs.device)
        self.Qs, self.mode = Qs, mode
        self.sels = {int(m): torch.from_numpy(np.nonzero(Qs.ms == m)[0]).to(
            dev) for m in np.unique(Qs.ms)}
        self.W = torch.full((R, L), PAD, dtype=torch.int8, device=dev)
        self.out = torch.empty((Qs.ms.size, R, L), dtype=torch.int32,
                               device=dev)
        self.graph = None
        if dev.type == "cuda":
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._body()
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._body()

    def _body(self):
        _last_rows_body(self.Qs, self.W, self.mode, self.sels, self.out)

    def __call__(self, windows: np.ndarray) -> torch.Tensor:
        self.W.copy_(torch.from_numpy(windows))
        if self.graph is not None:
            self.graph.replay()
        else:
            self._body()
        return self.out


def first_calls(Qs: Queries, windows, wlens, rows: LastRows):
    scores = rows(windows).permute(1, 0, 2).cpu().numpy()
    norm = scores / np.maximum(Qs.ms[None, :, None], 1)
    R = windows.shape[0]
    best_q = np.zeros(R, np.int64)
    best_d = np.zeros(R, np.int64)
    best_e = np.full(R, -1, np.int64)
    for r in range(R):
        L = int(wlens[r])
        if L == 0:
            continue
        col_min = norm[r, :, :L].min(axis=0)
        near = col_min <= float(col_min.min()) + TOL
        left = np.ones(L, bool)
        left[1:] = col_min[1:] <= col_min[:-1]
        right = np.ones(L, bool)
        right[:-1] = col_min[:-1] <= col_min[1:]
        cand = np.nonzero(near & left & right)[0]
        if cand.size == 0:
            cand = np.nonzero(near)[0]
        j = int(cand[0])
        q = int(np.argmin(norm[r, :, j]))
        best_q[r], best_d[r], best_e[r] = q, int(scores[r, q, j]), j
    return best_q, best_d, best_e


def later_calls(Qs: Queries, windows, wlens, rows: LastRows):
    D = rows(windows).to(torch.int64)                      # (Q, R, L)
    dev = D.device
    L = D.shape[2]
    m = torch.from_numpy(Qs.ms).to(dev)[:, None]
    cols = torch.arange(L, device=dev)[None, None, :]
    wl = torch.from_numpy(np.asarray(wlens, np.int64)).to(dev)[None, :, None]
    D = torch.where(cols < wl, D, torch.iinfo(torch.int64).max)
    mn = D.min(dim=2).values                                 # (Q, R)
    first = torch.argmax((D == mn[:, :, None]).to(torch.int8), dim=2)
    dist = torch.minimum(mn, m)
    end = torch.where(mn < m, first, -1)
    q = torch.argmin(dist.double() / m.double(), dim=0)     # (R,)
    r = torch.arange(q.numel(), device=dev)
    return (q.cpu().numpy(), dist[q, r].cpu().numpy(),
            end[q, r].cpu().numpy())


def decompose(monomers: dict, reads: list, config: dict, device,
              strands=("fwd", "rc")) -> dict:
    """{read id: [(sym, r_st, r_en, '+' or '-'), ...]} for (id, sequence)
    reads. config: `slack`, `max_divergence`."""
    Qs = Queries(monomers, strands, device)
    Wlen = Qs.max_m + int(config["slack"])
    codes = [encode(s) for _, s in reads]
    r_lens = np.array([c.size for c in codes], np.int64)
    R = len(reads)
    min_tail = int(Qs.mean_len * 0.5)
    pos = np.zeros(R, np.int64)
    rows = [[] for _ in range(R)]
    first = True
    # every step scores R windows (those of finished reads are PAD and
    # their results dropped), so that one captured step serves them all
    steps = {"HW": LastRows(Qs, R, Wlen, "HW"),
             "SHW": LastRows(Qs, R, Wlen, "SHW")}
    while True:
        act = np.nonzero(pos + min_tail <= r_lens)[0]
        if act.size == 0:
            break
        windows = np.full((R, Wlen), PAD, np.int8)
        for k, r in enumerate(act):
            piece = codes[r][pos[r]:pos[r] + Wlen]
            windows[k, :piece.size] = piece
        wlens = np.zeros(R, np.int64)
        wlens[:act.size] = np.minimum(Wlen, r_lens[act] - pos[act])
        q, d, e = (first_calls if first else later_calls)(
            Qs, windows, wlens, steps["HW" if first else "SHW"])
        q, d, e = q[:act.size], d[:act.size], e[:act.size]
        p = pos[act]
        mlen = Qs.ms[q]
        if first:
            r_en = p + e + 1
            r_st = np.maximum(p, r_en - mlen)
        else:
            r_st, r_en = p, p + e + 1
        gap = e < 0
        r_st = np.where(gap, p, r_st)
        r_en = np.where(gap, p + mlen, r_en)
        ok = ~gap & (d <= float(config["max_divergence"]) * mlen)
        for k, r in enumerate(act.tolist()):
            rows[r].append((int(q[k]), int(r_st[k]), int(r_en[k]),
                            "+" if ok[k] else "-"))
        pos[act] = r_en
        first = False
    return {reads[r][0]: rows[r] for r in range(R)}
