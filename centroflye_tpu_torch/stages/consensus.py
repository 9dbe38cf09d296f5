"""Template-based consensus polishing (in-repo replacement for Flye
`--polish-target`), a host copy of the JAX package's `stages/consensus.py`
on the port's native library.

The reference launches one external `flye --polish-target` subprocess per
unit position / pseudounit (reference eltr_polisher.py:99-114,
debruijn_graph.py:627-635). Here each read segment is aligned to the
template (ops/align_path), votes are piled per template column (base /
deletion) and per inter-column gap (inserted strings), and the majority
rewrite becomes the next template, iterated `n_iters` times. Ties break
lexicographically (deletion sorts before bases), so outputs are
reproducible bit-for-bit.

Hot path: alignments run as ONE threaded native batch
(cf_align_path_batch, banded traceback), and the voting is numpy
run-length arithmetic over the CIGAR runs — '='/'D' runs become
prefix-sum difference updates, only the rare 'X'/'I' events touch
per-event Python. When any pair of the batch reports failure (a negative
distance), the whole round takes the per-aligned-character walk instead,
as the JAX package does.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from centroflye_tpu_torch.io.encoding import encode
from centroflye_tpu_torch.native import native_align_path_batch
from centroflye_tpu_torch.ops.align_path import align_path
from centroflye_tpu_torch.utils.bio import parse_cigar

_BASE_IDX = {"-": 0, "A": 1, "C": 2, "G": 3, "T": 4}
_IDX_BASE = "-ACGT"


def _majority(counter: Counter, default: str) -> str:
    if not counter:
        return default
    # max count; ties -> lexicographically smallest key ('' and '-' first)
    best = max(counter.items(), key=lambda kv: (kv[1], ), default=None)
    top = best[1]
    cands = sorted(k for k, v in counter.items() if v == top)
    return cands[0]


def _iter_cigar(cigar: str):
    num = 0
    for ch in cigar:
        if "0" <= ch <= "9":
            num = num * 10 + (ord(ch) - 48)
        else:
            yield num, ch
            num = 0


def _batch_cigars(template: str, reads: Sequence[str]
                  ) -> Optional[List[str]]:
    """All read-vs-template NW CIGARs from one threaded native batch, or
    None when any pair failed (a negative distance)."""
    res = native_align_path_batch(
        [encode(r) for r in reads], encode(template), mode="NW")
    if any(r[0] < 0 for r in res):
        return None
    return [r[1] for r in res]


def _batch_alignments(template: str, reads: Sequence[str]):
    """All read-vs-template NW alignments as (a1, a2) pairs: one threaded
    native batch call (cf_align_path_batch), or the per-pair path for
    every read when any pair of the batch failed. Results are identical
    where both succeed — the batch API runs the same cf_align_path per
    pair."""
    res = native_align_path_batch(
        [encode(r) for r in reads], encode(template), mode="NW")
    if all(r[0] >= 0 for r in res):
        out = []
        for read, (dist, cigar, t_start, t_end) in zip(reads, res):
            _, _, a1, a2 = parse_cigar(cigar, read,
                                       template[t_start:t_end])
            out.append((a1, a2))
        return out
    return [(al.a1, al.a2) for al in
            (align_path(r, template, mode="NW") for r in reads)]


def _polish_round_aligned(template: str, reads: Sequence[str]) -> str:
    """Exact per-aligned-char voting walk (the path when a batch pair
    fails, and the oracle)."""
    n = len(template)
    base_votes: List[Counter] = [Counter() for _ in range(n)]
    ins_votes: List[Counter] = [Counter() for _ in range(n + 1)]
    for a1, a2 in _batch_alignments(template, reads):
        t_pos = 0
        pending_ins: List[str] = []
        for qc, tc in zip(a1, a2):
            if tc == "-":
                pending_ins.append(qc)
                continue
            ins_votes[t_pos][("".join(pending_ins))] += 1
            pending_ins = []
            base_votes[t_pos][qc if qc != "-" else "-"] += 1
            t_pos += 1
        ins_votes[n]["".join(pending_ins)] += 1
    out: List[str] = []
    for j in range(n):
        ins = _majority(ins_votes[j], "")
        if ins:
            out.append(ins)
        base = _majority(base_votes[j], template[j])
        if base != "-":
            out.append(base)
    tail = _majority(ins_votes[n], "")
    if tail:
        out.append(tail)
    return "".join(out)


def polish_round(template: str, reads: Sequence[str]) -> str:
    """One voting round: align every read to the template and rewrite each
    column by majority."""
    n = len(template)
    if n == 0 or not reads:
        return template
    cigars = _batch_cigars(template, reads)
    if cigars is None:
        return _polish_round_aligned(template, reads)
    return vote_from_cigars(template, cigars, reads)


def vote_from_cigars(template: str, cigars: Sequence[str],
                     reads: Sequence[str],
                     offsets: Optional[Sequence[int]] = None,
                     min_coverage: int = 1) -> str:
    """Majority rewrite of `template` from read-vs-template CIGARs
    ('I' = extra read char, 'D' = read deletion). Callers holding
    template-vs-read alignments (e.g. the final-polish HW anchors)
    transpose by swapping I<->D first — the aligned pairs are identical,
    only the op labels flip.

    offsets[i] is the template column where cigar i starts (default 0 —
    full-template coverage, the eltr polisher's case). A cigar votes
    only on the columns it covers; columns covered by fewer than
    min_coverage cigars keep the template character (and gaps covered by
    fewer than min_coverage cast no insertion), so partially-overlapping
    reads contribute votes near their ends instead of being discarded
    wholesale."""
    n = len(template)

    # run-length voting: '='/'D' runs as difference arrays, 'X'/'I' as
    # sparse per-event lists (a cigar covers every template column in
    # [offset, offset + consumed), so each read casts exactly one base
    # vote per covered column and one insertion vote — possibly '' —
    # per covered gap)
    match_diff = np.zeros(n + 1, np.int64)
    del_diff = np.zeros(n + 1, np.int64)
    cov_diff = np.zeros(n + 1, np.int64)      # covered columns
    gap_cov_diff = np.zeros(n + 2, np.int64)  # covered gaps [off, off+len]
    x_pos: List[int] = []
    x_idx: List[int] = []
    extra: Counter = Counter()        # (col, char) for non-ACGT read chars
    ins_nonempty = np.zeros(n + 1, np.int64)
    ins_by_gap: Dict[int, Counter] = {}   # gap -> {string: count}
    for ci, (cigar, read) in enumerate(zip(cigars, reads)):
        t = 0 if offsets is None else int(offsets[ci])
        t0 = t
        r = 0
        for length, op in _iter_cigar(cigar):
            if op == "=":
                match_diff[t] += 1
                match_diff[t + length] -= 1
                t += length
                r += length
            elif op == "X":
                for i in range(length):
                    idx = _BASE_IDX.get(read[r + i], -1)
                    if idx > 0:
                        x_pos.append(t + i)
                        x_idx.append(idx)
                    else:
                        extra[(t + i, read[r + i])] += 1
                t += length
                r += length
            elif op == "D":
                del_diff[t] += 1
                del_diff[t + length] -= 1
                t += length
            else:  # 'I'
                ins_by_gap.setdefault(t, Counter())[
                    read[r:r + length]] += 1
                ins_nonempty[t] += 1
                r += length
        cov_diff[t0] += 1
        cov_diff[min(t, n)] -= 1
        gap_cov_diff[t0] += 1
        gap_cov_diff[min(t, n) + 1] -= 1

    cov = np.cumsum(cov_diff)[:n]
    gap_cov = np.cumsum(gap_cov_diff)[:n + 1]
    counts = np.zeros((n, 5), np.int64)
    counts[:, 0] = np.cumsum(del_diff)[:n]
    tidx = np.array([_BASE_IDX.get(c, 0) for c in template], np.int64)
    counts[np.arange(n), tidx] += np.cumsum(match_diff)[:n]
    if x_pos:
        np.add.at(counts, (np.asarray(x_pos), np.asarray(x_idx)), 1)
    # first-max argmax == smallest key among ties ('-' < 'A' < ... < 'T')
    best = np.argmax(counts, axis=1)
    # columns with non-ACGT votes: recompute exactly with a full Counter
    overrides: Dict[int, str] = {}
    extra_by_col: Dict[int, Counter] = {}
    for (p, ch), v in extra.items():
        extra_by_col.setdefault(p, Counter())[ch] += v
    for j, cex in extra_by_col.items():
        c = Counter({_IDX_BASE[a]: int(counts[j, a])
                     for a in range(5) if counts[j, a]})
        c.update(cex)
        overrides[j] = _majority(c, template[j])

    ins_gaps: Dict[int, str] = {}
    for g, c in ins_by_gap.items():
        if int(gap_cov[g]) < min_coverage:
            continue
        empty = int(gap_cov[g]) - int(ins_nonempty[g])
        # fast path: when at least as many covering reads saw NO
        # insertion as saw one, '' wins outright (any nonempty string's
        # count <= ins_nonempty <= empty, and _majority breaks ties
        # lexicographically — '' first); most gaps carry one or two
        # noisy insertion events against dozens of clean reads, so this
        # skips the Counter + sort for ~95% of gaps
        if empty >= int(ins_nonempty[g]):
            continue
        cand = Counter(c)
        if empty > 0:
            cand[""] += empty
        maj = _majority(cand, "")
        if maj:
            ins_gaps[g] = maj

    # vectorized assembly: per-column chars from the argmax (template
    # where under-covered, override columns patched), '-' columns
    # dropped by mask, the few insertion strings spliced between
    # segments — replaces the per-column Python loop
    tcodes = np.frombuffer(template.encode("ascii"), np.uint8)
    lut = np.frombuffer(b"-ACGT", np.uint8)
    sel = lut[best]
    lowc = cov < min_coverage
    sel = np.where(lowc, tcodes, sel)
    for j, b in overrides.items():
        if not lowc[j]:
            sel[j] = ord(b)
    keep = sel != ord("-")
    if not ins_gaps:
        return sel[keep].tobytes().decode("ascii")
    parts: List[str] = []
    prev = 0
    for g in sorted(ins_gaps):
        parts.append(sel[prev:g][keep[prev:g]].tobytes().decode("ascii"))
        parts.append(ins_gaps[g])
        prev = g
    parts.append(sel[prev:n][keep[prev:n]].tobytes().decode("ascii"))
    return "".join(parts)


def polish_consensus(template: str, reads: Sequence[str],
                     n_iters: int = 2) -> Dict[int, str]:
    """Iterated polishing; returns {iteration (1-based): polished sequence}
    (mirroring the per-iteration artifacts polished_{i}.fasta the reference
    polisher reads back, eltr_polisher.py:116-131)."""
    out: Dict[int, str] = {}
    cur = template
    for i in range(1, n_iters + 1):
        if reads:
            prev = cur
            cur = polish_round(cur, reads)
            out[i] = cur
            if cur == prev:
                # fixed point: the round is deterministic in (template,
                # reads), so every later iteration returns the same
                # sequence — fill without re-aligning (most positions
                # converge by round 2; the reference burns all 4 Flye
                # iterations regardless, eltr_polisher.py:99-114)
                for j in range(i + 1, n_iters + 1):
                    out[j] = cur
                break
        else:
            out[i] = cur
    return out
