"""NCRF report compatibility: parse real NCRF output into Decomposition.

For bit-for-bit parity runs against the reference pipeline, the external
NCRF binary's report is treated as a pinned input artifact and parsed with
the exact semantics of the reference parser (reference ncrf_parser.py:61-118
record parsing + strand canonicalization; :28-59 per-unit motif splitting
with partial-unit patching at :49-52; :91-92 longest-alignment-only with
min_record_len). The result is the same Decomposition structure our own
unit decomposition stage produces, so every downstream stage runs unchanged
on either source.

Host code, a copy of the parser half of the JAX package's
`stages/ncrf_compat.py` (`split_motif_alignment`, `parse_ncrf_report`).
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
