"""Greedy read placement into the cloud contig (tandem-repeat resolution).

Exact reimplementation of the reference ReadPlacer (reference
read_placer.py:15-128): prefix reads seed the contig at position 0; then
internal and suffix reads are placed one per iteration by a greedy argmax
over (score tuple, rightmost position, lexicographically smallest r_id),
subject to score[0] >= min_unit, score[1] >= min_inters and
score[1] >= min_prop * score[0] — with scores maintained incrementally so
each iteration only processes the k-mers that just became frequent.

The scoring inner loop (99% of the work at scale) runs through the array
engine stages/placement_fast.FastPlacer (device bulk scoring via
ops/scoring + incremental per-row best caches) by default; the greedy
argmax itself is inherently sequential and stays exact, and
`use_fast=False` keeps the dict/Counter transcription as the debug
oracle. Output is the same read_positions.csv artifact
("r_id pos [score0 score1]" / "r_id None").

A copy of the JAX package's `stages/read_placer.py`; the fast engine
scores on the placer's `device`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from centroflye_tpu_torch.config import PlacerConfig
from centroflye_tpu_torch.io.fasta import atomic_write
from centroflye_tpu_torch.stages.cloud_contig import (
    CloudContig, build_kmers2pos, update_mapping_scores,
)
from centroflye_tpu_torch.stages.kmer_cloud import ReadClouds
from centroflye_tpu_torch.stages.placement_fast import (ArrayContig,
                                                        FastPlacer)


class ReadPlacer:
    """Greedy placer. `use_fast=True` (default) runs the array/device
    engine (stages/placement_fast.FastPlacer) on `device`;
    `use_fast=False` runs the dict-of-Counters oracle below — the
    near-verbatim mirror of the reference loop, kept for cross-checking
    only."""

    def __init__(self, config: PlacerConfig | None = None,
                 use_fast: bool = True, device="cuda"):
        self.config = config or PlacerConfig()
        self.use_fast = use_fast
        self.device = device
        if use_fast:
            # production contig: the sorted-key-table ArrayContig (one
            # vectorized merge per placed read); the dict-of-Counters
            # CloudContig below is the cross-checking oracle
            self.contig = ArrayContig(self.config.min_cloud_kmer_freq)
        else:
            self.contig = CloudContig(self.config.min_cloud_kmer_freq)
        self.placements: Dict[str, Optional[int]] = {}
        self.scores: Dict[str, Tuple[int, int]] = {}

    def add_prefix_reads(self, prefix_reads: Sequence[str],
                         reads_clouds: Dict[str, ReadClouds]):
        """Seed the contig with all prefix reads at position 0
        (reference read_placer.py:35-40)."""
        for r_id in prefix_reads:
            self.contig.add_read(reads_clouds[r_id], position=0)
            self.placements[r_id] = 0

    def add_reads(self, reads: Sequence[str],
                  reads_clouds: Dict[str, ReadClouds]):
        """Greedy placement loop (reference read_placer.py:42-94), exact
        including tie-breaking: strictly-better score must pass the validity
        thresholds; equal score prefers larger position, then smaller r_id."""
        if not reads:
            return
        if self.use_fast:
            placer = FastPlacer(self.contig, reads, reads_clouds,
                                self.config, device=self.device)
            placements, scores = placer.run()
            self.placements.update(placements)
            self.scores.update(scores)
            return
        self._add_reads_oracle(reads, reads_clouds)

    def _add_reads_oracle(self, reads: Sequence[str],
                          reads_clouds: Dict[str, ReadClouds]):
        """Dict-of-Counters mirror of the reference loop — oracle only."""
        cfg = self.config
        kmers2pos = build_kmers2pos(reads_clouds, reads)
        unused = set(reads)
        scores = None
        freq_kmers = [(kmer, pos) for kmer in self.contig.freq_kmers
                      for pos in self.contig.kmer_positions[kmer]]
        while unused:
            scores = update_mapping_scores(self.contig, kmers2pos,
                                           freq_kmers=freq_kmers,
                                           scores=scores)
            best_score, best_position, best_read = (-1, -1), None, None
            for r_id in unused:
                for pos in scores[r_id]:
                    ctr = scores[r_id][pos]
                    score = (len(ctr), sum(ctr.values()))
                    if (score > best_score and
                            score[0] >= cfg.min_unit and
                            score[0] * cfg.min_prop <= score[1] and
                            score[1] >= cfg.min_inters) or \
                        (score == best_score and pos > best_position) or \
                            (score == best_score and
                             pos == best_position and
                             r_id < best_read):
                        best_score = score
                        best_position = pos
                        best_read = r_id
            if best_read is None:
                for r_id in unused:
                    self.placements[r_id] = None
                return
            self.placements[best_read] = best_position
            self.scores[best_read] = best_score
            freq_kmers = self.contig.add_read(reads_clouds[best_read],
                                              position=best_position)
            unused.remove(best_read)

    def run(self, decomposition, reads_clouds: Dict[str, ReadClouds]):
        """Full placement (reference read_placer.py:96-128): classify,
        seed with prefix reads, place internal then suffix reads."""
        prefix, internal, suffix = decomposition.classify(
            large_threshold=self.config.prefix_threshold,
            small_threshold=self.config.small_threshold)
        self.add_prefix_reads(prefix, reads_clouds)
        self.add_reads(internal, reads_clouds)
        self.add_reads(suffix, reads_clouds)
        return self.placements

    def write_positions(self, filename: str):
        """read_positions.csv artifact (reference read_placer.py:36-89
        format: prefix reads "r_id 0"; placed "r_id pos s0 s1";
        unplaced "r_id None")."""
        with atomic_write(filename) as f:
            for r_id, pos in self.placements.items():
                if pos is None:
                    print(r_id, None, file=f)
                elif r_id in self.scores:
                    s = self.scores[r_id]
                    print(r_id, pos, s[0], s[1], file=f)
                else:
                    print(r_id, pos, file=f)


def read_positions_file(filename: str) -> Dict[str, Optional[int]]:
    """Parse read_positions.csv (reference eltr_polisher.py:19-30)."""
    out: Dict[str, Optional[int]] = {}
    with open(filename) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 2:
                continue
            r_id, p = parts[0], parts[1]
            out[r_id] = None if p == "None" else int(p)
    return out
