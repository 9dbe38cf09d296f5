"""Bio utility parity helpers (reference scripts/utils/bio.py), a host
copy of the JAX package's `utils/bio.py`: wildcard Hamming distance
(:64-72), identity_shift (:75-92), the overlap aligner (:95-144) and
extended-cigar parsing (:147-188). The IO and encoding helpers live in
`io/`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


def hamming_distance(s1: Sequence, s2: Sequence,
                     match_char: Set = frozenset()) -> Tuple[int, int]:
    """(mismatches, compared_length) over the common prefix; characters in
    match_char are wildcards (reference utils/bio.py:64-72)."""
    dist = 0
    n = 0
    for x, y in zip(s1, s2):
        n += 1
        if x in match_char or y in match_char:
            continue
        dist += x != y
    return dist, n


def identity_shift(s1: Sequence, s2: Sequence, min_overlap: int,
                   match_char: Set = frozenset()) -> Dict:
    """Best overlap shift of s2 against s1 by Hamming identity (reference
    utils/bio.py:75-92)."""
    best_identity, best_shift, best_hd, best_len = 0.0, None, None, None
    alt_shifts: List[int] = []
    for shift in range(len(s1) - min_overlap):
        hd, cur_len = hamming_distance(s1[shift:], s2,
                                       match_char=match_char)
        if cur_len == 0:
            continue
        identity = 1 - hd / cur_len
        if identity == best_identity:
            alt_shifts.append(shift)
        if identity > best_identity:
            best_identity = identity
            best_shift = shift
            best_hd = hd
            best_len = cur_len
            alt_shifts = []
    return {"id": best_identity, "shift": best_shift, "hd": best_hd,
            "len": best_len, "alt_shifts": alt_shifts}


def overlap_alignment(s1: str, s2: str, mismatch: int, sigma: int):
    """Overlap alignment: suffix of s1 against prefix of s2, +1 match,
    -mismatch substitution, -sigma gap (reference OverlapAlignment,
    utils/bio.py:95-144). Returns (score, a1, a2, s1_start) where a1/a2 are
    '|'-delimited aligned strings in the reference's format."""
    n, m = len(s1) + 1, len(s2) + 1
    t1 = " " + s1
    t2 = " " + s2
    w = np.zeros((n, m), dtype=np.int64)
    w[0, 1:] = -sigma * np.arange(1, m)
    for i in range(1, n):
        match = np.where(
            np.frombuffer(t2[1:].encode(), np.uint8) == ord(t1[i]),
            1, -mismatch)
        # vectorized row update: diag/up; horizontal via running max
        diag = w[i - 1, :-1] + match
        up = w[i - 1, 1:] - sigma
        best = np.maximum(diag, up)
        row = np.empty(m, np.int64)
        row[0] = w[i - 1, 0]  # no penalty on s1 prefix (free start)
        run = row[0]
        for j in range(1, m):
            v = max(best[j - 1], run - sigma)
            row[j] = v
            run = v
        w[i] = row
    lrow_max = int(w[-1].max())
    jmax = int(next(j for j in range(1, m) if w[-1, j] == lrow_max))
    a1: List[str] = []
    a2: List[str] = []
    i, j = n - 1, jmax
    while i != 0 and j != 0:
        sc = 1 if t1[i] == t2[j] else -mismatch
        if w[i, j] == w[i - 1, j - 1] + sc:
            a1.append(t1[i])
            a2.append(t2[j])
            i, j = i - 1, j - 1
        elif w[i, j] == w[i - 1, j] - sigma:
            a1.append(t1[i])
            a2.append("-")
            i -= 1
        elif w[i, j] == w[i, j - 1] - sigma:
            a1.append("-")
            a2.append(t2[j])
            j -= 1
        else:
            break
    s1_al = "".join(reversed(a1))
    s2_al = "".join(reversed(a2))
    s1_al = t1[1:i + 1] + "|" + s1_al + "|" + "-" * (m - jmax - 1)
    s2_al = "-" * i + "|" + s2_al + "|" + t2[jmax + 1:]
    assert len(s1_al) == len(s2_al)
    return int(w[n - 1, jmax]), s1_al, s2_al, i


def parse_cigar(cigar: str, s1: Optional[str] = None,
                s2: Optional[str] = None):
    """Parse an extended cigar over =/X/I/D; with sequences, also build the
    gapped alignment strings (reference utils/bio.py:147-188)."""
    import re

    parsed: List[Tuple[int, str]] = []
    counts = dict.fromkeys("=XID", 0)
    st = 0
    for mo in re.finditer(r"=|X|I|D", cigar):
        group = mo.group()
        region_len = int(cigar[st:mo.start()])
        parsed.append((region_len, group))
        counts[group] += region_len
        st = mo.end()
    if s1 is None or s2 is None:
        return parsed, counts

    a1: List[str] = []
    a2: List[str] = []
    i1 = i2 = 0
    for region_len, group in parsed:
        if group in "=X":
            seg1 = s1[i1:i1 + region_len]
            seg2 = s2[i2:i2 + region_len]
            if group == "=":
                assert seg1 == seg2
            a1.append(seg1)
            a2.append(seg2)
            i1 += region_len
            i2 += region_len
        elif group == "D":
            a1.append("-" * region_len)
            a2.append(s2[i2:i2 + region_len])
            i2 += region_len
        elif group == "I":
            a2.append("-" * region_len)
            a1.append(s1[i1:i1 + region_len])
            i1 += region_len
    return parsed, counts, "".join(a1), "".join(a2)


# import-time self-check, mirroring the reference's inline assert
# (utils/bio.py:187-188)
assert parse_cigar("89=1X6=3X76=") == (
    [(89, "="), (1, "X"), (6, "="), (3, "X"), (76, "=")],
    {"=": 171, "X": 4, "I": 0, "D": 0})
