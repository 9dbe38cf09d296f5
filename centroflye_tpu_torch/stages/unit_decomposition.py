"""Tandem decomposition records: the `DecompRecord` and `Decomposition`
dataclasses of the JAX package's `stages/unit_decomposition.py`, copied
(host code). The decomposer itself is not ported yet; stage 3 consumes
only these records, through `pipeline/cenx.py`'s decomposition file.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class DecompRecord:
    """Canonical per-read tandem record (strand '-' already flipped into
    reverse-complement coordinates, like the reference's parse-time
    canonicalization at ncrf_parser.py:96-99)."""

    r_id: str
    r_len: int
    strand: str
    r_st: int                 # canonical start of the tandem interval
    r_en: int                 # canonical end (exclusive)
    seq: str                  # canonical read substring [r_st:r_en)
    bounds: np.ndarray        # int32 instance boundaries into seq;
    #                           bounds[0] == 0, bounds[-1] == len(seq)

    @property
    def n_units(self) -> int:
        return len(self.bounds) - 1

    def motif_alignments(self) -> List[str]:
        """Per-unit-instance read substrings (role of
        NCRF_Record.get_motif_alignments(n=1).r_al with gaps stripped)."""
        return [self.seq[self.bounds[i]:self.bounds[i + 1]]
                for i in range(self.n_units)]


@dataclasses.dataclass
class Decomposition:
    """Full decomposition output for a read set."""

    records: Dict[str, DecompRecord]
    # per read: all tandem intervals in ORIGINAL read coordinates
    positions_all: Dict[str, List[Tuple[int, int, str]]]
    read_lens: Dict[str, int]
    discarded: List[str]

    def get_efficiency(self):
        """Per-read and global fraction of tandem-aligned read length the
        kept (longest) record actually uses — the reference's diagnostic
        (reference ncrf_parser.py:147-164; intervals there are inclusive,
        ours are half-open, so lengths here are en - st).

        Returns ({r_id: used_fraction}, global_fraction)."""
        efficiency: Dict[str, float] = {}
        total_length = 0
        total_used = 0
        for r_id, alignments in self.positions_all.items():
            all_len = sum(en - st for st, en, _ in alignments)
            total_length += all_len
            if r_id not in self.records or all_len == 0:
                efficiency[r_id] = 0.0
            else:
                rec = self.records[r_id]
                used = rec.r_en - rec.r_st
                total_used += used
                efficiency[r_id] = used / all_len
        global_eff = total_used / total_length if total_length else 0.0
        return efficiency, global_eff

    def classify(self, large_threshold: int, small_threshold: int = 1000):
        """Partition reads into prefix / internal / suffix reads by flanking
        non-repeat sequence (same rule as reference ncrf_parser.py:120-145:
        left_pos/right_pos derived from the outermost alignments in
        canonical orientation)."""
        prefix_reads, suffix_reads, internal_reads = [], [], []
        for r_id, record in self.records.items():
            r_len = self.read_lens[r_id]
            alignments = sorted(self.positions_all[r_id])
            if record.strand == "+":
                left_pos = alignments[0][0]
                right_pos = alignments[-1][1]
            else:
                left_pos = r_len - alignments[-1][1]
                right_pos = r_len - alignments[0][0]
            if left_pos > large_threshold \
                    and right_pos > r_len - small_threshold \
                    and right_pos == record.r_en:
                prefix_reads.append(r_id)
            elif right_pos < r_len - large_threshold \
                    and left_pos < small_threshold \
                    and left_pos == record.r_st:
                suffix_reads.append(r_id)
            else:
                internal_reads.append(r_id)
        return prefix_reads, internal_reads, suffix_reads
