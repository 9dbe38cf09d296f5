"""Final assembly-level polishing (tandemQUAST `--only-polish` role), a
host copy of the JAX package's `stages/final_polish.py` on the port's
native library.

The reference's last stage re-polishes the eltr assembly with the raw
reads through the external tandemQUAST submodule
(reference centroFlye.py:252-272: `tandemQUAST --nano <reads> --only-polish`,
output polishing2/polished/polished_{i}.fasta copied to
final_assembly.fasta). The submodule is not vendored in the reference
repo, so this is an in-repo equivalent with the same role: catch residual
errors — mostly at unit boundaries, where the per-position eltr polisher
(stages/polisher.py) had the least read context — by re-aligning full
read spans against the assembled nucleotide sequence and re-voting.

Design: each iteration partitions the assembly into contiguous windows
(~one unit long) and polishes every window independently with the voting
consensus (stages/consensus.polish_round) over read segments re-anchored
by banded infix alignment (the native Myers engine with threshold k).
Window phase alternates between iterations (offset by half a window), so
any boundary of one round is interior to the next — the window seams
cannot accumulate. Reads are located through their placements (the same
coordinate source the eltr polisher uses, reference eltr_polisher.py:53-66),
with an alignment margin that absorbs indel drift.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from centroflye_tpu_torch.io.encoding import compress_homopolymer, encode
from centroflye_tpu_torch.io.fasta import write_seqs
from centroflye_tpu_torch.native import native_align_path_pairs
from centroflye_tpu_torch.ops.align_path import align_path
from centroflye_tpu_torch.stages.consensus import vote_from_cigars
from centroflye_tpu_torch.stages.polisher import _edit_distance


def _anchor_segment(template: str, read_seq: str, lo: int, hi: int,
                    max_div: float) -> Optional[str]:
    """Best infix match of `template` inside read_seq[lo:hi]; None when
    the alignment diverges more than max_div."""
    target = read_seq[max(0, lo):min(len(read_seq), hi)]
    if len(target) < len(template) // 2:
        return None
    al = align_path(template, target, mode="HW")
    if al.dist > max_div * len(template):
        return None
    if al.t_end <= al.t_start:
        return None
    return target[al.t_start:al.t_end]


_TRANSPOSE = str.maketrans("ID", "DI")


def _anchor_segments_batched(tasks, max_div: float,
                             max_slip: Optional[int] = None):
    """Run every (window, template, target, offset[, expected_t_start])
    anchor alignment as ONE threaded native pairs batch; returns
    {task_index: (segment, read-vs-template cigar)} applying the same
    filters as _anchor_segment. The HW cigar is template-vs-read;
    swapping I<->D transposes it to the read-vs-template orientation
    the voting core expects (the aligned pairs are identical).

    max_slip: when a task carries an expected anchor position (5th
    element), reject alignments landing further than this from it.
    Tandem units are ~99.7% identical, so an HW anchor whose search
    window admits a NEIGHBORING unit copy can lock onto it and vote
    that copy's variants into the window (measured at the 1500u shape:
    a truth-perfect eltr unit gained 13 edits in tandem polish); a
    landing a unit-length away from the span-predicted position is
    such a wrong-copy lock, not drift.

    When any pair of the batch reports failure (a negative distance),
    every task takes the per-pair host path instead, as in the JAX
    package."""
    def slip_ok(task, ts):
        if max_slip is None or len(task) < 5 or task[4] is None:
            return True
        return abs(ts - task[4]) <= max_slip

    res = None
    if tasks:
        res = native_align_path_pairs(
            [encode(t[1]) for t in tasks],
            [encode(t[2]) for t in tasks], mode="HW")
    out = {}
    if res is not None and all(r[0] >= 0 for r in res):
        for idx, (task, (dist, cig, ts, te)) in enumerate(
                zip(tasks, res)):
            template, target = task[1], task[2]
            if dist > max_div * len(template) or te <= ts \
                    or not slip_ok(task, ts):
                continue
            out[idx] = (target[ts:te], cig.translate(_TRANSPOSE))
        return out
    for idx, task in enumerate(tasks):
        template, target = task[1], task[2]
        al = align_path(template, target, mode="HW")
        if al.dist > max_div * len(template) or al.t_end <= al.t_start \
                or not slip_ok(task, al.t_start):
            continue
        out[idx] = (target[al.t_start:al.t_end],
                    al.cigar.translate(_TRANSPOSE))
    return out


def polish_assembly_with_reads(
    assembly: str,
    read_spans: Sequence[Tuple[str, float, float]],   # (seq, frac_s, frac_e)
    *,
    n_iters: int = 2,
    window: int = 2048,
    max_div: float = 0.35,
    min_coverage: int = 3,
) -> Dict[int, str]:
    """Iteratively re-polish `assembly` from raw read sequences.

    read_spans carries each read's tandem-region sequence plus its
    approximate span on the assembly as FRACTIONS of the assembly length
    (so spans survive small length changes between iterations). Returns
    {iteration (1-based): polished assembly} like the reference's
    polished_{i}.fasta chain.
    """
    out: Dict[int, str] = {}
    cur = assembly
    for it in range(1, n_iters + 1):
        n = len(cur)
        if n == 0 or not read_spans:
            out[it] = cur
            continue
        phase = 0 if it % 2 == 1 else window // 2
        bounds = []
        a = 0
        first_end = phase if phase else min(window, n)
        while a < n:
            b = min(n, first_end if a == 0 else a + window)
            if b <= a:
                b = min(n, a + window)
            bounds.append((a, b))
            a = b
        margin = window // 3 + 64
        # conservative clip at read-estimated boundaries: span estimates
        # carry a few hundred bp of drift, so a partially-overlapping
        # read votes only on the part of the window it confidently
        # covers (losing up to `shrink` columns per read end instead of
        # the whole window, as full-containment-only voting did)
        shrink = window // 8 + 32
        min_sub = max(64, window // 4)
        # collect every (window, clipped template, read segment, column
        # offset) anchor task, run them as one threaded native pairs
        # batch, then vote per window with per-column coverage gating
        tasks = []
        for w, (a, b) in enumerate(bounds):
            for seq, fs, fe in read_spans:
                s = fs * n
                e = fe * n
                if s >= b or e <= a:
                    continue
                ta = a if s <= a else min(b, int(s) + shrink)
                tb = b if e >= b else max(a, int(e) - shrink)
                if tb - ta < min_sub:
                    continue
                template = cur[ta:tb]
                # read-local coordinates of the clipped window, with
                # drift margin
                lo = int(ta - s) - margin
                hi = int(tb - s) + margin
                target = seq[max(0, lo):min(len(seq), hi)]
                if len(target) < len(template) // 2:
                    continue
                # expected anchor landing inside `target`: the window's
                # span-predicted read-local start, clipped like target
                exp_ts = int(ta - s) - max(0, lo)
                tasks.append((w, template, target, ta - a, exp_ts))
        anchored = _anchor_segments_batched(tasks, max_div,
                                            max_slip=margin - 32)
        segs_by_window: Dict[int, list] = {}
        for idx, (seg, cig) in anchored.items():
            segs_by_window.setdefault(tasks[idx][0], []).append(
                (seg, cig, tasks[idx][3]))
        pieces = []
        for w, (a, b) in enumerate(bounds):
            template = cur[a:b]
            pairs = segs_by_window.get(w, [])
            # per-column gating: columns covered by < min_coverage reads
            # keep the template (a lone noisy read cannot replace it);
            # voting reuses the anchor alignments directly (no NW
            # re-alignment of segments the anchor pass already aligned)
            if pairs:
                pieces.append(vote_from_cigars(
                    template, [c for _, c, _ in pairs],
                    [s for s, _, _ in pairs],
                    offsets=[o for _, _, o in pairs],
                    min_coverage=min_coverage))
            else:
                pieces.append(template)
        cur = "".join(pieces)
        out[it] = cur
    return out


def spans_from_placements(placements: Dict[str, Optional[int]],
                          records, total_len_units: Optional[int] = None
                          ) -> Sequence[Tuple[str, float, float]]:
    """Read spans (sequence, fractional start, fractional end) from unit
    placements and decomposition records (rec.seq = strand-canonical
    tandem region, rec.n_units instances)."""
    placed = [(r, p) for r, p in placements.items()
              if p is not None and r in records]
    if not placed:
        return []
    total = total_len_units or max(
        p + records[r].n_units for r, p in placed)
    total = max(total, 1)
    spans = []
    for r, p in placed:
        rec = records[r]
        spans.append((rec.seq, p / total,
                      min(1.0, (p + rec.n_units) / total)))
    return spans


def run_final_polish(assembly: str,
                     placements: Dict[str, Optional[int]],
                     records,
                     outdir: str,
                     *,
                     n_iters: int = 2,
                     window: int = 2048) -> str:
    """Stage driver: writes polishing2/polished/polished_{i}.fasta per
    iteration (the reference's artifact layout, centroFlye.py:265-266)
    and returns the last iteration's sequence."""
    spans = spans_from_placements(placements, records)
    if spans and assembly:
        # windows must sit well below the typical read span or no read
        # fully contains them and every window keeps its template
        med = np.median([(fe - fs) * len(assembly)
                          for _, fs, fe in spans])
        window = int(min(window, max(256, med / 2)))
    polished = polish_assembly_with_reads(
        assembly, spans, n_iters=n_iters, window=window)
    pol_dir = os.path.join(outdir, "polished")
    os.makedirs(pol_dir, exist_ok=True)
    for it, seq in polished.items():
        write_seqs(os.path.join(pol_dir, f"polished_{it}.fasta"),
                   {f"polished_{it}": seq})
    # convergence diagnostics between successive iterations, plain and
    # homopolymer-compressed (the reference polish-comparison pattern,
    # eltr_polisher.py:133-146)
    chain = [assembly] + [polished[i] for i in sorted(polished)]
    with open(os.path.join(outdir, "report.txt"), "w") as f:
        for i in range(len(chain) - 1):
            a, b = chain[i], chain[i + 1]
            d = _edit_distance(a, b)
            dh = _edit_distance(compress_homopolymer(a),
                                compress_homopolymer(b))
            print(f"Final polishing seq {i} vs {i + 1}:", file=f)
            print({"editDistance": d}, file=f)
            print(f"Final polishing homopolymer compressed seq {i} vs "
                  f"{i + 1}:", file=f)
            print({"editDistance": dh}, file=f)
    return polished.get(n_iters, assembly)
