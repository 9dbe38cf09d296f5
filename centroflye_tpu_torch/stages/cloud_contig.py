"""Cloud contig: consensus of placed reads in unit-coordinate space.

Exact reimplementation of the reference's CloudContig semantics
(reference cloud_contig.py:8-95): positions hold Counters of k-mers; a k-mer
becomes "frequent" at a position once seen min_cloud_kmer_freq times; the
placement score of a read at offset o is the tuple
(#read positions with >= 1 frequent-k-mer intersection, total intersections),
maintained incrementally through an inverted index (update_mapping_scores,
cloud_contig.py:87-95). K-mers are int64 indices into the unique-k-mer table
instead of strings.

The slow scorer calc_inters_score is kept as the cross-checking oracle
(the reference's own dual-implementation verification idea,
cloud_contig.py:146-155). The batched device scorer lives in ops/scoring.py
and is validated against this implementation.

Host code, a copy of the JAX package's `stages/cloud_contig.py`.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Tuple

from centroflye_tpu_torch.stages.kmer_cloud import ReadClouds


class CloudContig:
    def __init__(self, min_cloud_kmer_freq: int):
        self.max_pos = 0
        self.min_cloud_kmer_freq = max(1, min_cloud_kmer_freq)
        self.clouds: Dict[int, Counter] = defaultdict(Counter)
        self.freq_clouds: Dict[int, set] = defaultdict(set)
        self.freq_kmers: set = set()
        self.kmer_positions: Dict[int, set] = defaultdict(set)
        self.read_positions: Dict[str, int] = {}
        self.coverage: Dict[int, int] = defaultdict(int)

    def update_max_pos(self):
        self.max_pos = max(self.clouds.keys()) if self.clouds else 0

    def add_read(self, read_clouds: ReadClouds, position: int
                 ) -> List[Tuple[int, int]]:
        """Add a read's clouds at a unit offset; returns the k-mers that
        newly became frequent as (kmer, contig_pos) pairs
        (reference cloud_contig.py:26-41)."""
        self.read_positions[read_clouds.r_id] = position
        new_freq = []
        for i, cloud in enumerate(read_clouds.clouds):
            pos = i + position
            self.coverage[pos] += 1
            self.clouds[pos]  # materialize empty cloud like the reference
            for kmer in cloud.tolist():
                self.kmer_positions[kmer].add(pos)
                self.clouds[pos][kmer] += 1
                if self.clouds[pos][kmer] == self.min_cloud_kmer_freq:
                    self.freq_clouds[pos].add(kmer)
                    self.freq_kmers.add(kmer)
                    new_freq.append((kmer, pos))
        self.update_max_pos()
        assert len(set(new_freq)) == len(new_freq)
        return new_freq

    def calc_inters_score(self, read_clouds: ReadClouds,
                          min_position: int = 0,
                          max_position: Optional[int] = None,
                          min_unit: int = 2, min_inters: int = 10
                          ) -> Tuple[Tuple[int, int], Optional[int]]:
        """Slow oracle scorer (reference cloud_contig.py:46-76): scan all
        offsets; keep the rightmost best valid score."""
        if max_position is None:
            max_position = self.max_pos
        best_score, best_pos = (0, 0), None
        kmers = read_clouds.clouds
        for pos in range(min_position, max_position + 1):
            score = [0, 0]
            max_i = min(self.max_pos - pos + 1, len(kmers))
            for i in range(max_i):
                inters = self.freq_clouds[pos + i] & set(kmers[i].tolist())
                score[0] += len(inters) >= 1
                score[1] += len(inters)
            score = tuple(score)
            if score[0] >= min_unit and score[1] >= min_inters \
                    and score >= best_score:
                best_score = score
                best_pos = pos
        return best_score, best_pos


def update_mapping_scores(cloud_contig: CloudContig,
                          kmers2pos: Dict[int, List[Tuple[str, int]]],
                          freq_kmers: List[Tuple[int, int]],
                          scores=None):
    """Incremental inverted-index scoring (reference cloud_contig.py:87-95):
    for each newly frequent (kmer, contig_pos), bump
    scores[r_id][contig_pos - read_pos][read_pos] for every read position
    holding that k-mer (offsets < 0 skipped)."""
    if scores is None:
        scores = defaultdict(lambda: defaultdict(Counter))
    for kmer, cc_pos in freq_kmers:
        if kmer in kmers2pos:
            for r_id, pos in kmers2pos[kmer]:
                if cc_pos >= pos:
                    scores[r_id][cc_pos - pos][pos] += 1
    return scores


def build_kmers2pos(reads_clouds: Dict[str, ReadClouds],
                    read_ids=None) -> Dict[int, List[Tuple[str, int]]]:
    """Inverted index: kmer -> [(r_id, instance_pos)] (reference
    read_placer.py:44-49)."""
    kmers2pos: Dict[int, List[Tuple[str, int]]] = defaultdict(list)
    ids = read_ids if read_ids is not None else reads_clouds.keys()
    for r_id in ids:
        rc = reads_clouds[r_id]
        for i, cloud in enumerate(rc.clouds):
            for kmer in cloud.tolist():
                kmers2pos[kmer].append((r_id, i))
    return kmers2pos


def map_reads_fast(cloud_contig: CloudContig,
                   reads_clouds: Dict[str, ReadClouds],
                   threshold=(5, 10), debug: bool = False):
    """Re-map all reads against a built contig via the incremental scorer
    (reference cloud_contig.py:117-156); with debug=True cross-checks each
    placement against the slow oracle scorer."""
    kmers2pos = build_kmers2pos(reads_clouds)
    freq = [(kmer, pos) for kmer in cloud_contig.freq_kmers
            for pos in cloud_contig.kmer_positions[kmer]]
    scores = update_mapping_scores(cloud_contig, kmers2pos, freq)
    positions = {}
    mismatches = []
    for r_id, rc in reads_clouds.items():
        best_score, best_pos = (0, 0), None
        for pos, score_ctr in scores[r_id].items():
            if pos + rc.n_units > len(cloud_contig.clouds):
                continue
            score = (len(score_ctr), sum(score_ctr.values()))
            if score[0] < threshold[0] or score[1] < threshold[1]:
                continue
            if (score > best_score) or \
                    (score == best_score and best_pos is not None
                     and pos > best_pos):
                best_pos = pos
                best_score = score
        if best_pos is not None:
            positions[r_id] = best_pos
            if debug:
                max_pos = cloud_contig.max_pos - rc.n_units + 1
                slow_score, slow_pos = cloud_contig.calc_inters_score(
                    rc, max_position=max_pos,
                    min_unit=threshold[0], min_inters=threshold[1])
                if slow_score != best_score or slow_pos != best_pos:
                    mismatches.append((r_id, best_score, slow_score,
                                       best_pos, slow_pos))
    if debug:
        return positions, scores, mismatches
    return positions, scores
