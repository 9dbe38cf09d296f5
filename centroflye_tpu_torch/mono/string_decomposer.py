"""Monomer decomposition of reads (the in-repo StringDecomposer), on one
device or a mesh.

The port of the JAX package's `mono/string_decomposer.py`. The reference
depends on the external StringDecomposer to translate each centromeric
read into a sequence of monomer alignments (reference README.md:184-196;
its TSV is parsed by sd_parser.py:158-192). Here the reads of a batch
advance in LOCKSTEP through a chain of anchored alignments: each step
aligns every monomer (both strands: 2n queries, each with its own peq
table and length) against each active read's current window, picks the
best monomer by distance over its length (the first on ties), emits the
call and moves to the alignment's end. The first step runs in HW mode
(free start) and takes the earliest near-optimal local minimum, to lock
onto the monomer phase; the later steps run in SHW mode (anchored start,
free end).

Each step is one call of `ops/myers_cuda.myers_perrow`: kernel K4 on the
card, its plain version (`ops/myers.myers_distance_batch`) on the CPU. A
later step scores only the active reads' windows and chooses each one's
call on the device, so it reads back three int32 a window; the first
step reads back every score and chooses on the host. The host work of a
step is numpy over the whole batch (the windows cut from one code plane,
the calls applied to every active read at once), and the records equal
the JAX package's row for row.

The lockstep batch is sized for the card, not for the host: a read's
chain of steps reads only its own codes and position, so its records do
not depend on which reads share its batch, and the port's default batch
(4,096 reads, 147,456 rows at 36 queries) puts a whole recruited read set
into one launch a step, enough rows to fill the card's SMs, where the
JAX package's 32 reads ran many short launches. The steps of a batch are
as many as its longest read has records.

With a mesh (`parallel/mesh.Mesh` of more than one device), each step's
active windows split over it (padded to a device multiple with empty
windows): one K4 launch a shard, the 12-byte calls concatenated in window
order (`parallel/mesh.make_perrow_myers_step`), so the records are the
single-device ones.

Output rows are (monomer_sym, r_st, r_en, reliability) per read, the
information of the SD TSV, for SDReport.from_decomposition.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from centroflye_tpu_torch.io.encoding import PAD, encode, revcomp
from centroflye_tpu_torch.ops.myers import build_peq, words_tensor
from centroflye_tpu_torch.ops.myers_cuda import PERROW_CALLS, perrow_queries
from centroflye_tpu_torch.parallel.mesh import (
    Mesh, make_perrow_myers_step, pad_rows, resolve_mesh)


@dataclasses.dataclass
class MonomerDecomposerConfig:
    # reliability: best distance <= max_divergence * monomer_len -> '+'
    max_divergence: float = 0.45
    # lockstep batch of reads: sized to fill the card (the records do not
    # depend on it; the JAX package's default is 32)
    batch_reads: int = 4096
    # window slack beyond the longest monomer
    slack: int = 64


class MonomerDecomposer:
    def __init__(self, monomers: Dict[str, str],
                 config: MonomerDecomposerConfig | None = None,
                 device="cuda", *, state: dict | None = None, mesh=None):
        """device: where the alignment steps run; "cuda" raises without a
        card. state: {"peqs", "ms"} tensors from
        `convert.decomposer_state_from_numpy`, used in place of the
        tables built from `monomers`. mesh: None, "auto" or a `Mesh` of
        `device`'s type (`parallel/mesh.resolve_mesh`): the steps' windows
        shard over it, and `device` becomes its first device."""
        self.config = config or MonomerDecomposerConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MonomerDecomposer: CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        self.mesh = resolve_mesh(mesh, self.device)
        # without a mesh, the steps run as the one shard of `device`
        self.shards = self.mesh or Mesh([self.device])
        self.device = self.shards.first
        self.names = list(monomers.keys())
        self.n = len(self.names)
        seqs = list(monomers.values())
        self.max_m = max(len(s) for s in seqs)
        self.mean_len = float(np.mean([len(s) for s in seqs]))
        # queries: n forward + n reverse-complement monomers
        peqs = [build_peq(encode(s), m=self.max_m) for s in seqs]
        peqs += [build_peq(revcomp(encode(s)), m=self.max_m) for s in seqs]
        self.peqs = np.stack(peqs)                      # (2n, 5, W) uint32
        self.ms = np.array([len(s) for s in seqs] * 2, np.int32)  # (2n,)
        if state is None:
            state = {"peqs": words_tensor(self.peqs, self.device),
                     "ms": torch.from_numpy(self.ms)}
        # checked and laid out for the kernel once, not at every step
        self.queries = perrow_queries(state["peqs"], state["ms"],
                                      m=self.max_m, device=self.device)
        self._steps = {
            call: make_perrow_myers_step(
                self.shards, self.queries.peqs, self.queries.ms,
                m=self.max_m, mode=call[0], collect=call[1])
            for call in PERROW_CALLS}
        self.window = self.max_m + self.config.slack

    def _device_batch(self, windows: np.ndarray, lens: np.ndarray,
                      mode: str, collect: str = "best"):
        """One lockstep call on the device: every query against each of
        the R windows, rows r * Q + q (K4 on the card, one launch a
        shard; the windows padded to a shard multiple with empty ones,
        whose outputs are sliced away). -> its outputs as numpy, and R,
        Q."""
        R, Q = windows.shape[0], 2 * self.n
        n_dev = self.shards.size
        out = self._steps[mode, collect](
            pad_rows(np.ascontiguousarray(windows), n_dev, PAD),
            pad_rows(lens, n_dev, 0))
        rows = {"scores": R * Q}
        return ({k: v[:rows.get(k, R)].cpu().numpy()
                 for k, v in out.items()}, R, Q)

    def _step(self, windows: np.ndarray, lens: np.ndarray):
        """One lockstep SHW step: windows (R, window) int8 -> each
        window's (query_index, dist, end), chosen on the device: the query
        of least dist over its length, the first on ties."""
        out, _, _ = self._device_batch(windows, lens, "SHW", collect="call")
        return out["q"], out["dist"], out["end"]

    def _first_step(self, windows: np.ndarray, lens: np.ndarray,
                    tol: float = 0.05):
        """Phase-locking step: HW (free start) but choosing the EARLIEST
        near-optimal alignment end, not the global best — otherwise a
        slightly noisier first monomer instance would be skipped in favor
        of a cleaner later one."""
        out, R, Q = self._device_batch(windows, lens, "HW", collect="all")
        scores = out["scores"].reshape(R, Q, -1)
        norm = scores / np.maximum(self.ms[None, :, None], 1)
        best_q = np.zeros(R, np.int64)
        best_d = np.zeros(R, np.int64)
        best_e = np.full(R, -1, np.int64)
        for r in range(R):
            L = int(lens[r])
            if L == 0:
                continue
            col_min = norm[r, :, :L].min(axis=0)
            global_min = float(col_min.min())
            near = col_min <= global_min + tol
            # earliest LOCAL minimum among near-optimal columns (a column on
            # a still-descending slope is not an alignment end)
            left_ok = np.empty(L, bool)
            left_ok[0] = True
            left_ok[1:] = col_min[1:] <= col_min[:-1]
            right_ok = np.empty(L, bool)
            right_ok[-1] = True
            right_ok[:-1] = col_min[:-1] <= col_min[1:]
            candidates = np.nonzero(near & left_ok & right_ok)[0]
            if len(candidates) == 0:
                candidates = np.nonzero(near)[0]
            j = int(candidates[0])
            q = int(np.argmin(norm[r, :, j]))
            best_q[r] = q
            best_d[r] = int(scores[r, q, j])
            best_e[r] = j
        return best_q, best_d, best_e

    def decompose(self, reads: Iterable[Tuple[str, str]]
                  ) -> Dict[str, List[Tuple[int, int, int, str]]]:
        """Returns {r_id: [(sym, r_st, r_en, reliability), ...]} with sym in
        [0, n) forward / [n, 2n) reverse."""
        out: Dict[str, List[Tuple[int, int, int, str]]] = {}
        reads = list(reads)
        B = self.config.batch_reads
        for b0 in range(0, len(reads), B):
            chunk = reads[b0:b0 + B]
            out.update(self._decompose_batch(chunk))
        return out

    def _decompose_batch(self, chunk):
        cfg = self.config
        Wlen = self.window
        codes = [encode(seq) for _, seq in chunk]
        r_lens = np.array([len(c) for c in codes], np.int64)
        R = len(chunk)
        # one code plane, each read followed by Wlen PAD codes: a read's
        # window at any position it can reach is one slice of it
        offs = np.zeros(R, np.int64)
        offs[1:] = np.cumsum(r_lens[:-1] + Wlen)
        plane = np.full(int(r_lens.sum()) + R * Wlen, PAD, np.int8)
        for r, c in enumerate(codes):
            plane[offs[r]:offs[r] + len(c)] = c
        # every window a read can reach, as a strided view of the plane
        starts = np.lib.stride_tricks.sliding_window_view(plane, Wlen)
        pos = np.zeros(R, np.int64)
        steps = []          # per step: (reads, sym, r_st, r_en, reliable)
        first = True
        # min remaining bases to bother aligning another monomer
        min_tail = int(self.mean_len * 0.5)
        while True:
            act = np.nonzero(pos + min_tail <= r_lens)[0]
            if len(act) == 0:
                break
            # the active reads' windows only
            windows = starts[offs[act] + pos[act]]
            wlens = np.minimum(Wlen, r_lens[act] - pos[act]).astype(np.int32)
            if first:
                best_q, dist, end = self._first_step(windows, wlens)
            else:
                best_q, dist, end = self._step(windows, wlens)
            q, d, e = best_q.astype(np.int64), dist, end.astype(np.int64)
            p = pos[act]
            mlen = self.ms[q].astype(np.int64)
            if first:
                # free start: locate the instance start by its end
                r_en = p + e + 1
                r_st = np.maximum(p, r_en - mlen)
            else:
                r_st, r_en = p, p + e + 1
            # no alignment progress: a gap step of one monomer's length
            gap = e < 0
            r_st = np.where(gap, p, r_st)
            r_en = np.where(gap, p + mlen, r_en)
            reliable = ~gap & (d <= cfg.max_divergence * mlen)
            steps.append((act, q, r_st, r_en, reliable))
            pos[act] = r_en
            first = False
        rows: List[List[Tuple[int, int, int, str]]] = [[] for _ in range(R)]
        for act, q, r_st, r_en, reliable in steps:
            for r, row in zip(act.tolist(), zip(
                    q.tolist(), r_st.tolist(), r_en.tolist(),
                    np.where(reliable, "+", "-").tolist())):
                rows[r].append(row)
        return {chunk[r][0]: rows[r] for r in range(R)}


def decompose_to_monostrings(monomers: Dict[str, str],
                             reads: Iterable[Tuple[str, str]],
                             config: MonomerDecomposerConfig | None = None,
                             max_gap: int = 100, device="cuda", mesh=None):
    """reads -> SDReport (monoreads) without the external tool; mesh as
    `MonomerDecomposer`'s."""
    from centroflye_tpu_torch.mono.sd_parser import SDReport

    dec = MonomerDecomposer(monomers, config, device=device, mesh=mesh)
    records = dec.decompose(reads)
    return SDReport.from_decomposition(
        records, dec.names, max_gap=max_gap,
        mean_monomer_len=dec.mean_len)
