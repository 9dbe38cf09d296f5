"""NCRF report compatibility: parse real NCRF output into Decomposition.

For bit-for-bit parity runs against the reference pipeline, the external
NCRF binary's report is treated as a pinned input artifact and parsed with
the exact semantics of the reference parser (reference ncrf_parser.py:61-118
record parsing + strand canonicalization; :28-59 per-unit motif splitting
with partial-unit patching at :49-52; :91-92 longest-alignment-only with
min_record_len). The result is the same Decomposition structure our own
unit decomposition stage produces, so every downstream stage runs unchanged
on either source.

Host code, a copy of the JAX package's `stages/ncrf_compat.py`: the
parser (`split_motif_alignment`, `parse_ncrf_report`), and the writer
of a decomposition as an NCRF-like report (`write_ncrf_like_report`,
its alignments from the port's `ops/align_path`) with its debug dump
(`extract_motif_alignments`).
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np

from centroflye_tpu_torch.io.encoding import revcomp_str
from centroflye_tpu_torch.stages.unit_decomposition import (DecompRecord,
                                                            Decomposition)

_FIRST = re.compile(r"^([^ ]+)\s+(\d+)\s+(\d+)bp\s+(\d+)-(\d+)\s+(.+)$")
_SECOND = re.compile(r"^([^+-]+)([+-])\s+(\d+)bp\s+score=(-?\d+)\s+(.+)$")


def split_motif_alignment(motif: str, m_al: str, r_al: str
                          ) -> List[Tuple[int, int]]:
    """Unit-instance boundaries in alignment coordinates: regex-match the
    motif with interleaved gap runs against the motif side of the alignment
    (reference NCRF_Record.get_motif_alignments, ncrf_parser.py:28-59),
    patching leading/trailing partials longer than 0.2*|motif|."""
    pattern = "".join(f"{re.escape(base)}(?:[-]*)" for base in motif)
    m_al_u = m_al.upper()
    coords = [mo.start() for mo in re.finditer(pattern, m_al_u)]
    if not coords:
        return []
    # end of the last full match
    last = None
    for mo in re.finditer(pattern, m_al_u):
        last = mo.end()
    coords.append(last)
    if coords[0] > len(motif) * 0.2:
        coords.insert(0, 0)
    if coords[-1] < len(r_al) - len(motif) * 0.2:
        coords.append(len(r_al))
    return list(zip(coords[:-1], coords[1:]))


def parse_ncrf_report(report_fn: str,
                      min_record_len: int = 5000) -> Decomposition:
    """Parse an NCRF report file into a Decomposition."""
    records: Dict[str, DecompRecord] = {}
    best_al_len: Dict[str, int] = {}
    positions_all: Dict[str, List[Tuple[int, int, str]]] = {}
    read_lens: Dict[str, int] = {}
    seen: List[str] = []

    with open(report_fn) as f:
        lines = [ln.strip() for ln in f]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]

    for i in range(0, len(lines) - 1, 2):
        fst = _FIRST.search(lines[i])
        snd = _SECOND.search(lines[i + 1])
        if not fst or not snd:
            continue
        r_id, r_len, r_al_len, r_st, r_en, r_al = fst.groups()
        motif, strand, m_al_len, al_score, m_al = snd.groups()
        r_len = int(r_len)
        r_al_len = int(r_al_len)
        r_st, r_en = int(r_st), int(r_en)
        seen.append(r_id)
        positions_all.setdefault(r_id, []).append((r_st, r_en, strand))
        read_lens[r_id] = r_len

        if r_id in best_al_len and best_al_len[r_id] >= r_al_len:
            continue
        if r_al_len < min_record_len:
            continue
        best_al_len[r_id] = r_al_len
        # canonicalize '-' strand records (reference ncrf_parser.py:96-99)
        if strand == "-":
            r_st, r_en = r_len - r_en, r_len - r_st
            r_al = revcomp_str(r_al)
            m_al = revcomp_str(m_al)

        # per-unit boundaries in alignment space -> read space (strip gaps)
        al_bounds = split_motif_alignment(motif, m_al, r_al)
        gaps = np.cumsum(np.frombuffer(r_al.encode(), np.uint8)
                         == ord("-"))
        seq = r_al.upper().replace("-", "")

        def to_read_coord(al_pos: int) -> int:
            if al_pos == 0:
                return 0
            return al_pos - int(gaps[al_pos - 1])

        # The reference's unit list keeps EXACTLY the regex-matched
        # segments (ncrf_parser.py:47-59): a truncated first/last unit
        # shorter than 0.2*|motif| is DISCARDED, not merged into its
        # neighbor — so bounds may start past 0 / end before len(seq),
        # and k-mers in the dropped margin belong to NO cloud.
        if al_bounds:
            bounds = [to_read_coord(al_bounds[0][0])]
            for (st, en) in al_bounds:
                b = to_read_coord(en)
                if b > bounds[-1]:
                    bounds.append(b)
        else:
            bounds = [0]
        records[r_id] = DecompRecord(
            r_id=r_id, r_len=r_len, strand=strand,
            r_st=r_st, r_en=r_en, seq=seq,
            bounds=np.array(bounds, dtype=np.int32))

    for r_id in positions_all:
        positions_all[r_id].sort()
    discarded = [r for r in dict.fromkeys(seen) if r not in records]
    return Decomposition(records=records, positions_all=positions_all,
                         read_lens=read_lens, discarded=discarded)


def write_ncrf_like_report(dec: Decomposition, motif: str,
                           out_fn: str) -> None:
    """Write our decomposition in an NCRF-like 2-line record format.

    Each unit instance contributes a TRUE gapped pairwise alignment of
    its read segment against the motif (computed with ops/align_path, the
    banded Myers PATH engine), so the motif side is exactly the motif's
    bases with interleaved '-' runs — the shape the reference parser's
    motif-regex splitting expects (reference ncrf_parser.py:28-59) — and
    the split reproduces this decomposition's instance boundaries on
    NOISY data too, enabling bit-for-bit parity runs of the reference's
    downstream Python stages at real parameters. Segments that equal the
    motif verbatim (noiseless data) skip the alignment.

    Records are DE-canonicalized on write ('-' strand records emit the
    reverse-complemented alignment and original-orientation coordinates) so
    any NCRF parser — the reference's or ours — re-canonicalizes them back
    to exactly this decomposition."""
    from centroflye_tpu_torch.io.fasta import atomic_write
    from centroflye_tpu_torch.ops.align_path import align_path

    with atomic_write(out_fn) as f:
        for r_id, rec in dec.records.items():
            r_parts = []
            m_parts = []
            for i in range(rec.n_units):
                st, en = int(rec.bounds[i]), int(rec.bounds[i + 1])
                seg = rec.seq[st:en]
                ln = en - st
                # which motif span this instance should carry: full motif
                # for interior instances; the tail/head for genuinely
                # partial first/last instances
                if ln == len(motif) and seg == motif:
                    r_parts.append(seg)
                    m_parts.append(motif)
                    continue
                if i == 0 and rec.n_units > 1 and ln < 0.8 * len(motif):
                    ref_side = motif[-min(ln, len(motif)):]
                elif i == rec.n_units - 1 and rec.n_units > 1 \
                        and ln < 0.8 * len(motif):
                    ref_side = motif[:min(ln, len(motif))]
                elif ln > len(motif) * 1.5:
                    # oversized instance (merged partials): repeat motif
                    ref_side = (motif * (ln // len(motif) + 1))[:ln]
                else:
                    ref_side = motif
                al = align_path(seg, ref_side, mode="NW")
                r_parts.append(al.a1)
                m_parts.append(al.a2)
            r_al = "".join(r_parts)
            m_al = "".join(m_parts)
            r_st, r_en = rec.r_st, rec.r_en
            if rec.strand == "-":
                r_al = revcomp_str(r_al)
                m_al = revcomp_str(m_al)
                r_st, r_en = rec.r_len - rec.r_en, rec.r_len - rec.r_st
            n_read_bases = sum(1 for ch in r_al if ch != "-")
            print(f"{r_id} {rec.r_len} {n_read_bases}bp "
                  f"{r_st}-{r_en} {r_al}", file=f)
            print(f"{motif}{rec.strand} {len(m_al)}bp score=0 {m_al}",
                  file=f)
            print("", file=f)


def extract_motif_alignments(dec: Decomposition, outdir: str,
                             buffer: int = 20) -> None:
    """Debug dump: per-read FASTA of unit-instance segments with `buffer`
    flanking bases (role of the reference's misc/extract_ncrf_mas.py tool)."""
    import os

    os.makedirs(outdir, exist_ok=True)
    for r_id, rec in dec.records.items():
        out_fn = os.path.join(outdir, f"{r_id}.fasta")
        with open(out_fn, "w") as f:
            for i in range(rec.n_units):
                st = max(0, int(rec.bounds[i]) - buffer)
                en = min(len(rec.seq), int(rec.bounds[i + 1]) + buffer)
                print(f">{r_id}|unit_{i}|{st}-{en}", file=f)
                print(rec.seq[st:en], file=f)
