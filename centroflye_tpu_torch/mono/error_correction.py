"""Monoread error correction (reference mono_error_correction.py).

Four passes, all vectorized over the int16 symbol arrays:
1. filter_lowercaserich_reads (:20-26): drop reads with > max_lowercase
   fraction of reverse-strand monomer calls (wrong-strand chimeras).
2. trim_reads (:29-49): trim gap-rich ends using a moving average of the
   gap indicator (window 30, threshold 0.2).
3. cut_gaprich_reads (:52-71): split reads with > 5% gaps into gap-free
   parts of >= 100 monomers.
4. correct_gaps (:74-101): infer the HOR as the contig of a k=3 monomer de
   Bruijn graph over very frequent 3-mers (canonical cyclic rotation), then
   overwrite any gap-containing window that Hamming-matches the HOR (gaps
   wildcard) with the clean HOR.

The port's copy of the JAX package's `mono/error_correction.py` (host numpy, no
device work), held against it by tests/test_torch_mono.py.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from centroflye_tpu_torch.mono.monostring import MonoString, GAP


def moving_average(x: np.ndarray, window: int) -> np.ndarray:
    cs = np.concatenate([[0.0], np.cumsum(x.astype(np.float64))])
    return (cs[window:] - cs[:-window]) / float(window)


def filter_lowercaserich_reads(monoreads: Dict[str, MonoString],
                               max_lowercase: float = 0.1
                               ) -> Dict[str, MonoString]:
    out = {}
    for r_id, m in monoreads.items():
        nongap = m.syms != GAP
        if not nongap.any():
            continue
        frac = float(m.is_reverse()[nongap].mean())
        if frac <= max_lowercase:
            out[r_id] = m
    return out


def trim_read(m: MonoString, max_gap: float = 0.2,
              ma_window: int = 30) -> MonoString:
    """Reference trim_read (:29-49): walk the moving average from both ends
    past gap-rich windows, keep [left, right + window], then strip."""
    is_gap = (m.syms == GAP).astype(np.float64)
    if len(is_gap) < ma_window:
        return m.strip()
    ma = moving_average(is_gap, ma_window)
    left = 0
    while left < len(ma) and ma[left] > max_gap:
        left += 1
    right = len(ma) - 1
    while right >= 0 and ma[right] > max_gap:
        right -= 1
    return m.trim(left, right + ma_window + 1).strip()


def trim_reads(monoreads: Dict[str, MonoString], max_gap: float = 0.2,
               ma_window: int = 30) -> Dict[str, MonoString]:
    return {r_id: trim_read(m, max_gap, ma_window)
            for r_id, m in monoreads.items()}


def cut_gaprich_reads(monoreads: Dict[str, MonoString],
                      max_gap: float = 0.05, min_length: int = 100):
    """Reference cut_gaprich_reads (:52-71). Returns (reads keyed by
    (r_id, part) for cut reads / (r_id, 0) for whole, n_cut, n_parts)."""
    out: Dict = {}
    cut_cnt = 0
    total_parts = 0
    for r_id, m in monoreads.items():
        if len(m) == 0:
            out[r_id] = m
            continue
        gap_prop = float((m.syms == GAP).mean())
        if gap_prop <= max_gap:
            out[(r_id, 0)] = m
        else:
            parts = m.split_on_gaps(min_length=min_length)
            n_parts = sum(len(p.syms) > 0 for p in parts.values())
            if n_parts:
                cut_cnt += 1
                total_parts += n_parts
            out.update(parts)
    return out, cut_cnt, total_parts


def hamming_with_wildcard(a: np.ndarray, b: np.ndarray) -> int:
    """Mismatches where neither side is GAP (reference utils/bio.py:64-72
    with match_char={'?'})."""
    care = (a != GAP) & (b != GAP)
    return int(((a != b) & care).sum())


def infer_hors(monoreads: Dict[str, MonoString], k: int = 3,
               min_mult: int = 5000) -> List[np.ndarray]:
    """Infer HOR(s) as contigs of a k=3 monomer de Bruijn graph over
    frequent gap-free 3-mers, canonically rotated (reference
    correct_gaps :77-84 via debruijn_graph.get_contigs)."""
    from centroflye_tpu_torch.mono.debruijn import (
        MonoDeBruijnGraph, get_frequent_kmers,
    )
    strings = {r_id: m.syms for r_id, m in monoreads.items()}
    frequent, _ = get_frequent_kmers(strings, k=k, min_mult=min_mult,
                                     with_locations=False)
    if not frequent:
        return []
    db = MonoDeBruijnGraph(k=k)
    db.add_kmers(frequent, coverage=frequent)
    contigs, _ = db.get_contigs()
    hors = [min_cyclic_shift_arr(np.array(c, dtype=np.int16))
            for c in contigs]
    hors.sort(key=lambda a: a.tolist())
    return hors


def min_cyclic_shift_arr(a: np.ndarray) -> np.ndarray:
    """Lexicographically minimal rotation of a symbol array."""
    if len(a) == 0:
        return a
    da = np.concatenate([a, a])
    best = 0
    for i in range(1, len(a)):
        for j in range(len(a)):
            x, y = da[best + j], da[i + j]
            if x != y:
                if y < x:
                    best = i
                break
    return da[best:best + len(a)].copy()


def correct_gaps(monoreads: Dict[str, MonoString], max_gap: float = 0.3,
                 nhor: int = 1, k: int = 3, min_mult: int = 5000
                 ) -> Dict[str, MonoString]:
    """HOR gap-filling (reference correct_gaps :74-101): any window with
    some-but-few gaps that Hamming-matches the HOR (gaps as wildcards)
    is overwritten with the clean HOR."""
    hors = infer_hors(monoreads, k=k, min_mult=min_mult)
    for m in monoreads.values():
        for single_hor in hors:
            for i_nhor in range(1, nhor + 1):
                hor = np.tile(single_hor, i_nhor)
                hl = len(hor)
                if hl == 0 or len(m) < hl:
                    continue
                syms = m.syms
                for i in range(len(syms) - hl + 1):
                    window = syms[i:i + hl]
                    gap_cnt = int((window == GAP).sum())
                    if gap_cnt == 0 or gap_cnt / hl > max_gap:
                        continue
                    if hamming_with_wildcard(window, hor) == 0:
                        syms[i:i + hl] = hor
    return monoreads


def error_correction(monoreads: Dict[str, MonoString],
                     verbose: bool = False, hor_correction: bool = True,
                     max_lowercase: float = 0.1, trim_max_gap: float = 0.2,
                     trim_ma_window: int = 30, cut_max_gap: float = 0.05,
                     cut_min_length: int = 100, hor_k: int = 3,
                     hor_min_mult: int = 5000, hor_max_gap: float = 0.3):
    """Full correction chain (reference error_correction :104-138)."""
    from centroflye_tpu_torch.mono.sd_parser import get_stats

    if verbose:
        get_stats(monoreads, verbose=True)
    filtered = filter_lowercaserich_reads(monoreads, max_lowercase)
    trimmed = trim_reads(filtered, trim_max_gap, trim_ma_window)
    cut, cut_cnt, total_parts = cut_gaprich_reads(
        trimmed, cut_max_gap, cut_min_length)
    if verbose:
        print(f"# cut reads = {cut_cnt}, # parts = {total_parts}")
    if hor_correction:
        cut = correct_gaps(cut, max_gap=hor_max_gap, k=hor_k,
                           min_mult=hor_min_mult)
    return cut
