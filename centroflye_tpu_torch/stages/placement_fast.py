"""Array-native greedy read placement (the production path).

Semantics are exactly the reference's greedy loop (reference
read_placer.py:42-94 + cloud_contig.py:85-95): one read placed per
iteration, winner = lexicographic max of ((score0, score1), position,
-r_id) over valid candidates, where
  score1[r, o] = number of processed (kmer, cc_pos) "frequent pairs"
                 matched by read r's cloud at t = cc_pos - o,
  score0[r, o] = number of distinct t with at least one match,
valid(score) = score0 >= min_unit and score1 >= min_inters and
score1 >= min_prop * score0. The processed-pair stream starts with the
snapshot {(kmer, pos): kmer globally frequent, pos in kmer_positions[kmer]}
(reference read_placer.py:54-58 — note: all positions of the k-mer, not
just positions where it is frequent) and is extended each iteration by the
placed read's newly-position-frequent pairs (cloud_contig.py:26-41); a pair
can legitimately appear in both, and then counts twice — a reference quirk
preserved for parity.

Array-native design instead of the reference's dict-of-Counters scan:
- scores live in dense (R, P) int32 arrays; the initial bulk scoring runs
  on the placer's device as a one-hot float32 matmul with exact counts
  (ops/scoring.placement_scores_matmul), or as the bitmap popcount
  correlation (ops/scoring.placement_scores) for very large k-mer
  vocabularies;
- per-iteration increments are fully vectorized (apply_pairs): occurrence
  expansion via searchsorted+repeat, per-cell count bookkeeping against a
  precomputed initial-snapshot base table, np.add.at scatter-adds, and a
  lexsort-grouped row-best refresh;
- the winner argmax is O(R) per iteration through per-row best caches
  (scores only ever increase, so a row's cached best stays exact until
  the row is touched).

The dict implementation (stages/read_placer.ReadPlacer.add_reads) is kept
as the cross-checking oracle, the reference's own slow/fast verification
pattern (cloud_contig.py:146-155).

A copy of the JAX package's `stages/placement_fast.py`: the greedy loop,
`apply_pairs` and the row-best caches stay host numpy; the bulk scoring
calls the port's `ops/scoring` on the placer's `device`. The placer logs
the seconds of its set-up, its bulk scoring (synchronised by the copy of
the scores to the host) and its greedy loop.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from centroflye_tpu_torch.config import PlacerConfig
from centroflye_tpu_torch.ops import scoring
from centroflye_tpu_torch.ops.myers import words_tensor
from centroflye_tpu_torch.stages.cloud_contig import CloudContig
from centroflye_tpu_torch.stages.kmer_cloud import ReadClouds
from centroflye_tpu_torch.utils.logging_utils import span

logger = logging.getLogger("centroflye_tpu_torch")

_NEG = np.int64(-1)
_KMASK = np.int64(0xFFFFFFFF)


class ArrayContig:
    """Array-native cloud contig — the production contig data structure.

    Same observable semantics as the reference's CloudContig (reference
    cloud_contig.py:8-41: positions hold k-mer multisets; a k-mer becomes
    "frequent" at a position once seen min_cloud_kmer_freq times; add_read
    reports the newly frequent (kmer, pos) pairs), but holds ONE sorted
    int64 key table ((pos << 32) | kmer_index -> count) instead of
    dict-of-Counters, so add_read is a single np.unique + searchsorted
    merge per read rather than a Python loop per k-mer occurrence. The
    dict implementation (stages/cloud_contig.CloudContig) remains the
    cross-checking oracle, the reference's own slow/fast verification
    pattern (reference cloud_contig.py:146-155)."""

    # pending-buffer flush threshold: inserts land in a small sorted
    # side table and fold into the main table only when it fills, so a
    # placed read costs O(batch + pending) instead of an O(table) copy
    _PENDING_CAP = 1 << 14

    def __init__(self, min_cloud_kmer_freq: int):
        self.min_cloud_kmer_freq = max(1, min_cloud_kmer_freq)
        self.max_pos = 0
        self.read_positions: Dict[str, int] = {}
        self._keys = np.empty(0, np.int64)     # sorted (pos << 32) | kmer
        self._cnts = np.empty(0, np.int64)
        self._pkeys = np.empty(0, np.int64)    # pending: sorted, disjoint
        self._pcnts = np.empty(0, np.int64)    # from _keys by construction
        self._positions: set = set()           # materialized positions
        self._freq_clouds_cache: Optional[Dict[int, set]] = None

    def _flush_pending(self):
        if not len(self._pkeys):
            return
        keys = np.concatenate([self._keys, self._pkeys])
        cnts = np.concatenate([self._cnts, self._pcnts])
        srt = np.argsort(keys, kind="stable")   # disjoint: plain merge
        self._keys, self._cnts = keys[srt], cnts[srt]
        self._pkeys = np.empty(0, np.int64)
        self._pcnts = np.empty(0, np.int64)

    @staticmethod
    def _probe(table_keys: np.ndarray, table_cnts: np.ndarray,
               ukeys: np.ndarray):
        """(exists_mask, idx, counts) of ukeys against one sorted table."""
        n = len(table_keys)
        idx = np.searchsorted(table_keys, ukeys)
        if n:
            idxc = np.minimum(idx, n - 1)
            exists = (idx < n) & (table_keys[idxc] == ukeys)
            return exists, idx, np.where(exists, table_cnts[idxc], 0)
        z = np.zeros(len(ukeys), np.int64)
        return np.zeros(len(ukeys), bool), idx, z

    def add_read(self, read_clouds: ReadClouds, position: int
                 ) -> List[Tuple[int, int]]:
        """Add a read's clouds at a unit offset; returns the k-mers that
        newly became frequent as (kmer, contig_pos) pairs (reference
        cloud_contig.py:26-41). Order of the returned pairs is
        unspecified (all downstream consumers are additive)."""
        self.read_positions[read_clouds.r_id] = position
        n_units = read_clouds.n_units
        if n_units:
            # the reference materializes a (possibly empty) cloud per
            # unit instance, so max_pos advances over empty clouds too
            self.max_pos = max(self.max_pos, position + n_units - 1)
            self._positions.update(range(position, position + n_units))
        parts = []
        for i, cloud in enumerate(read_clouds.clouds):
            if len(cloud):
                c = cloud.astype(np.int64)
                # keys pack as (pos << 32) | kmer: an out-of-range index
                # would silently alias into the position field
                if int(c.min()) < 0 or int(c.max()) >= (1 << 32):
                    raise ValueError(
                        f"k-mer index out of [0, 2^32) in read "
                        f"{read_clouds.r_id!r} cloud {i}")
                parts.append((np.int64(i + position) << np.int64(32)) | c)
        if not parts:
            return []
        ukeys, inc = np.unique(np.concatenate(parts), return_counts=True)
        in_main, idx_m, old_m = self._probe(self._keys, self._cnts, ukeys)
        in_pend, idx_p, old_p = self._probe(self._pkeys, self._pcnts, ukeys)
        old = old_m + old_p                     # tables are disjoint
        new = old + inc
        if in_main.any():
            self._cnts[idx_m[in_main]] = new[in_main]
        if in_pend.any():
            self._pcnts[idx_p[in_pend]] = new[in_pend]
        miss = ~(in_main | in_pend)
        if miss.any():
            # fold fresh keys into the pending table: both sides sorted
            # and disjoint, so a searchsorted insert is a linear merge
            # (the pending table is small — at most _PENDING_CAP)
            at = np.searchsorted(self._pkeys, ukeys[miss])
            self._pkeys = np.insert(self._pkeys, at, ukeys[miss])
            self._pcnts = np.insert(self._pcnts, at, new[miss])
            if len(self._pkeys) > self._PENDING_CAP:
                self._flush_pending()
        f = self.min_cloud_kmer_freq
        newly = ukeys[(old < f) & (new >= f)]
        if len(newly):
            self._freq_clouds_cache = None
        return [(int(k & _KMASK), int(k >> np.int64(32)))
                for k in newly.tolist()]

    # -- array views (FastPlacer fast paths) ------------------------------

    def occurrence_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(kmers, positions) over every (pos, kmer) pair seen >= 1 time,
        sorted by (pos, kmer) — CloudContig.kmer_positions as flat arrays."""
        self._flush_pending()
        return self._keys & _KMASK, self._keys >> np.int64(32)

    def freq_kmer_array(self) -> np.ndarray:
        """Sorted unique k-mers frequent at >= 1 position (the reference's
        global freq_kmers set)."""
        self._flush_pending()
        f = self._cnts >= self.min_cloud_kmer_freq
        return np.unique(self._keys[f] & _KMASK)

    # -- dict views (oracle-compatible API) --------------------------------

    @property
    def freq_kmers(self) -> set:
        return set(self.freq_kmer_array().tolist())

    @property
    def kmer_positions(self) -> Dict[int, set]:
        from collections import defaultdict
        d: Dict[int, set] = defaultdict(set)
        kmers, poss = self.occurrence_arrays()
        for k, p in zip(kmers.tolist(), poss.tolist()):
            d[k].add(p)
        return d

    @property
    def clouds(self) -> set:
        """Materialized positions — API shim so len(contig.clouds) (the
        reference's bound check, cloud_contig.py:137) works; per-position
        Counter access is the oracle CloudContig's job."""
        return self._positions

    @property
    def freq_clouds(self) -> Dict[int, set]:
        """pos -> set of k-mers frequent at pos (computed from a private
        cache; callers get a fresh defaultdict COPY each call, so probing
        a missing position or mutating a returned set cannot corrupt the
        cache — the oracle CloudContig rebuilds its dict per call too)."""
        from collections import defaultdict
        if self._freq_clouds_cache is None:
            self._flush_pending()
            d: Dict[int, set] = {}
            fkeys = self._keys[self._cnts >= self.min_cloud_kmer_freq]
            for k in fkeys.tolist():
                d.setdefault(k >> 32, set()).add(k & 0xFFFFFFFF)
            self._freq_clouds_cache = d
        return defaultdict(
            set, {p: set(s) for p, s in self._freq_clouds_cache.items()})

    def calc_inters_score(self, read_clouds: ReadClouds,
                          min_position: int = 0,
                          max_position: Optional[int] = None,
                          min_unit: int = 2, min_inters: int = 10):
        """Slow oracle scorer over this contig (duck-typed reuse of the
        oracle implementation — it reads only freq_clouds and max_pos)."""
        return CloudContig.calc_inters_score(
            self, read_clouds, min_position=min_position,
            max_position=max_position, min_unit=min_unit,
            min_inters=min_inters)


def _initial_pair_sets(contig) -> Dict[int, np.ndarray]:
    """pos -> sorted array of globally-frequent k-mers occurring at pos
    (the reference's initial freq_kmers snapshot, read_placer.py:54-58 —
    note: ALL positions of a globally frequent k-mer, not only positions
    where it is frequent)."""
    if isinstance(contig, ArrayContig):
        kmers, poss = contig.occurrence_arrays()
        fk = contig.freq_kmer_array()
        if len(fk) == 0 or len(kmers) == 0:
            return {}
        i = np.searchsorted(fk, kmers)
        ic = np.minimum(i, len(fk) - 1)
        keep = fk[ic] == kmers
        kmers, poss = kmers[keep], poss[keep]
        # occurrence_arrays is sorted by (pos, kmer): split on pos runs
        upos, starts = np.unique(poss, return_index=True)
        bounds = np.append(starts, len(poss))
        return {int(p): kmers[bounds[i]:bounds[i + 1]]
                for i, p in enumerate(upos.tolist())}
    per_pos: Dict[int, List[int]] = {}
    for kmer in contig.freq_kmers:
        for pos in contig.kmer_positions[kmer]:
            per_pos.setdefault(pos, []).append(kmer)
    return {pos: np.array(sorted(ks), dtype=np.int64)
            for pos, ks in per_pos.items()}


def _intersect_count(sorted_a: np.ndarray, sorted_b: np.ndarray) -> int:
    """|a & b| for sorted unique int arrays."""
    if len(sorted_a) == 0 or len(sorted_b) == 0:
        return 0
    if len(sorted_a) > len(sorted_b):
        sorted_a, sorted_b = sorted_b, sorted_a
    idx = np.searchsorted(sorted_b, sorted_a)
    idx = np.minimum(idx, len(sorted_b) - 1)
    return int(np.count_nonzero(sorted_b[idx] == sorted_a))


class FastPlacer:
    """One add_reads phase (internal or suffix reads) of the greedy loop."""

    def __init__(self, contig: CloudContig, reads: Sequence[str],
                 reads_clouds: Dict[str, ReadClouds],
                 config: PlacerConfig,
                 use_device_init: bool = True, device="cuda"):
        with span("placement_setup"):
            t0 = time.perf_counter()
            self.device = torch.device(device)
            self.contig = contig
            self.config = config
            self.ids: List[str] = list(reads)
            self.clouds = {r: reads_clouds[r] for r in self.ids}
            R = len(self.ids)
            # tie-break rank: smaller r_id (lexicographic) wins at equal
            # (score, position)
            order = sorted(range(R), key=lambda i: self.ids[i])
            self.lex_rank = np.empty(R, np.int64)
            for rank, i in enumerate(order):
                self.lex_rank[i] = rank

            self.T = max((self.clouds[r].n_units for r in self.ids), default=0)
            n_kmers = 0
            for r in self.ids:
                for c in self.clouds[r].clouds:
                    if len(c):
                        n_kmers = max(n_kmers, int(c.max()) + 1)
            if isinstance(contig, ArrayContig):
                ck, _ = contig.occurrence_arrays()
                if len(ck):
                    n_kmers = max(n_kmers, int(ck.max()) + 1)
            else:
                for kmer in contig.kmer_positions:
                    n_kmers = max(n_kmers, int(kmer) + 1)
            self.n_kmers = n_kmers

            # inverted occurrence index: kmer -> (read row, unit t), sorted by
            # kmer for vectorized lookup
            occ_k: List[np.ndarray] = []
            occ_r: List[np.ndarray] = []
            occ_t: List[np.ndarray] = []
            for ri, r in enumerate(self.ids):
                for t, c in enumerate(self.clouds[r].clouds):
                    if len(c):
                        occ_k.append(c.astype(np.int64))
                        occ_r.append(np.full(len(c), ri, np.int32))
                        occ_t.append(np.full(len(c), t, np.int32))
            if occ_k:
                k = np.concatenate(occ_k)
                srt = np.argsort(k, kind="stable")
                self.occ_kmer = k[srt]
                self.occ_read = np.concatenate(occ_r)[srt]
                self.occ_t = np.concatenate(occ_t)[srt]
            else:
                self.occ_kmer = np.empty(0, np.int64)
                self.occ_read = np.empty(0, np.int32)
                self.occ_t = np.empty(0, np.int32)

            self.P = int(contig.max_pos) + self.T + 2
            self.S0 = np.zeros((R, self.P), np.int32)
            self.S1 = np.zeros((R, self.P), np.int32)
            self.placed = np.zeros(R, bool)
            # per-cell match-count cache for score0's distinct-t rule:
            # key (r, o, t) -> processed-pair hits, held as a sorted
            # (key, value) main table plus a small sorted pending table
            # (disjoint from main; folded in when it fills) — every probe
            # and update is a vectorized searchsorted pass, no per-element
            # Python. Cells absent from both tables fall back to the
            # initial-snapshot intersection count, precomputed once as a
            # sorted (key, count) table
            self._cnt_keys = np.empty(0, np.int64)
            self._cnt_vals = np.empty(0, np.int64)
            self._cnt_pkeys = np.empty(0, np.int64)
            self._cnt_pvals = np.empty(0, np.int64)
            self._init_sets = _initial_pair_sets(contig)
            assert self.T < (1 << 20), "unit index overflows cell-key packing"
            self._base_keys, self._base_vals = self._build_base_counts()

            self._row_best_key = np.full(R, _NEG, np.int64)
            self._row_best_pos = np.full(R, -1, np.int64)

        t1 = time.perf_counter()
        with span("placement_scoring"):
            self._score_init(use_device_init)
        t2 = time.perf_counter()
        with span("placement_setup"):
            self._rebuild_row_best(np.arange(R))
        t3 = time.perf_counter()
        logger.info("placement set-up %.3fs, bulk scoring %.3fs (%d reads)",
                    (t1 - t0) + (t3 - t2), t2 - t1, R)

    # -- initial bulk scoring --------------------------------------------

    def _score_init(self, use_device: bool):
        R = len(self.ids)
        if R == 0:
            return
        if not self._init_sets:
            return
        max_pos = max(self._init_sets.keys())
        if use_device:
            self._score_init_device(max_pos)
        else:
            self._score_init_host(max_pos)

    def _score_init_host(self, max_pos: int):
        """Numpy mirror of the device bitmap scorer (oracle path)."""
        for ri, r in enumerate(self.ids):
            rc = self.clouds[r]
            for t, cloud in enumerate(rc.clouds):
                if not len(cloud):
                    continue
                c_sorted = np.sort(cloud.astype(np.int64))
                for pos, init_set in self._init_sets.items():
                    o = pos - t
                    if o < 0 or o >= self.P:
                        continue
                    n = _intersect_count(c_sorted, init_set)
                    if n:
                        self.S1[ri, o] += n
                        self.S0[ri, o] += 1

    # vocabularies past this go through the bitmap popcount path: the
    # matmul's one-hot operands scale linearly in V, the bitmaps in V/32
    _MATMUL_MAX_VOCAB = 1 << 17

    def _score_init_device(self, max_pos: int):
        """Bulk (R, P) scoring on the placer's device. Default: the matmul
        scorer (ops/scoring.placement_scores_matmul — one-hot clouds @
        one-hot contig, exact counts); very large k-mer vocabularies go
        through the bitmap popcount correlation
        (ops/scoring.placement_scores). Chunked over reads to bound the
        one-hot / bitmap working set."""
        R = len(self.ids)
        P_bm = min(self.P, max_pos + 1)
        K = max((len(c) for r in self.ids
                 for c in self.clouds[r].clouds), default=0)
        K = max(K, 1)
        tensor = np.full((R, self.T, K), -1, np.int32)
        for ri, r in enumerate(self.ids):
            for t, c in enumerate(self.clouds[r].clouds):
                tensor[ri, t, :len(c)] = c
        if self.n_kmers <= self._MATMUL_MAX_VOCAB:
            self._score_chunks_matmul(tensor, P_bm)
        else:
            self._score_chunks_popcount(tensor, P_bm)

    def _score_chunks_matmul(self, tensor: np.ndarray, P_bm: int):
        ck = np.concatenate(list(self._init_sets.values()))
        cp = np.concatenate(
            [np.full(len(ks), pos, np.int64)
             for pos, ks in self._init_sets.items()])
        keep = cp < P_bm
        dev = self.device
        ck = torch.from_numpy(ck[keep].astype(np.int32)).to(dev)
        cp = torch.from_numpy(cp[keep].astype(np.int32)).to(dev)
        R = tensor.shape[0]
        # the JAX package's chunk: reads such that a (Rc*T, V) bf16
        # one-hot stays ~256 MB (the port's float32 one-hot is twice
        # that); the tail chunk is not padded, as nothing compiles here
        chunk = max(1, (256 << 20) // max(1, 2 * self.T * self.n_kmers))
        for r0 in range(0, R, chunk):
            s0, s1 = scoring.placement_scores_matmul(
                torch.from_numpy(tensor[r0:r0 + chunk]).to(dev), ck, cp,
                n_kmers=self.n_kmers, n_pos=P_bm)
            self.S0[r0:r0 + chunk, :P_bm] = s0.cpu().numpy()
            self.S1[r0:r0 + chunk, :P_bm] = s1.cpu().numpy()

    def _score_chunks_popcount(self, tensor: np.ndarray, P_bm: int):
        R = tensor.shape[0]
        W = max(1, -(-self.n_kmers // 32))
        contig_bm = np.zeros((P_bm, W), np.uint32)
        for pos, ks in self._init_sets.items():
            if pos >= P_bm:
                continue
            # bitwise_or.at, not fancy-index |=: several k-mers share a
            # word and duplicate indices must all land
            np.bitwise_or.at(
                contig_bm[pos], ks // 32,
                (np.uint32(1) << (ks % 32).astype(np.uint32)
                 ).astype(np.uint32))
        contig_bm = words_tensor(contig_bm, self.device)
        # chunk reads so R_chunk * T * W uint32 stays ~64 MB
        chunk = max(1, (64 << 20) // max(1, 4 * self.T * W))
        for r0 in range(0, R, chunk):
            bm = scoring.clouds_to_bitmaps(tensor[r0:r0 + chunk],
                                           self.n_kmers)
            s0, s1 = scoring.placement_scores(
                words_tensor(bm, self.device), contig_bm)
            self.S0[r0:r0 + chunk, :P_bm] = s0.cpu().numpy()
            self.S1[r0:r0 + chunk, :P_bm] = s1.cpu().numpy()

    # -- row-best cache ---------------------------------------------------

    def _valid_key(self, s0: np.ndarray, s1: np.ndarray) -> np.ndarray:
        """(score0, score1) packed as an int64 sort key; -1 = invalid."""
        cfg = self.config
        # s1 >= 1 mirrors the dict version's candidate domain: a score
        # entry exists only where at least one pair ever matched
        valid = (s1 >= 1) & (s0 >= cfg.min_unit) & \
            (s1 >= cfg.min_inters) & (s1 >= cfg.min_prop * s0)
        key = (s0.astype(np.int64) << np.int64(32)) | s1.astype(np.int64)
        return np.where(valid, key, _NEG)

    def _rebuild_row_best(self, rows: np.ndarray):
        for ri in np.unique(rows):
            key = self._valid_key(self.S0[ri], self.S1[ri])
            m = key.max() if key.size else _NEG
            if m < 0:
                self._row_best_key[ri] = _NEG
                self._row_best_pos[ri] = -1
            else:
                self._row_best_key[ri] = m
                self._row_best_pos[ri] = \
                    int(np.nonzero(key == m)[0][-1])   # rightmost best

    def _grow_P(self, needed: int):
        newP = max(needed + 1, self.P * 2)
        padded0 = np.zeros((self.S0.shape[0], newP), np.int32)
        padded1 = np.zeros((self.S0.shape[0], newP), np.int32)
        padded0[:, :self.P] = self.S0
        padded1[:, :self.P] = self.S1
        self.S0, self.S1, self.P = padded0, padded1, newP

    # -- incremental updates ---------------------------------------------

    def _expand(self, kmers: np.ndarray, ccpos: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Occurrence expansion of a (kmer, cc_pos) pair stream against the
        inverted occurrence index: (read row, unit t, offset o) arrays over
        every occurrence of each k-mer, offsets < 0 dropped."""
        lo = np.searchsorted(self.occ_kmer, kmers, side="left")
        hi = np.searchsorted(self.occ_kmer, kmers, side="right")
        counts = hi - lo
        total = int(counts.sum())
        if total == 0:
            e = np.empty(0, np.int64)
            return e, e, e
        pair_idx = np.repeat(np.arange(len(kmers)), counts)
        prefix = np.cumsum(counts) - counts
        idx = np.repeat(lo - prefix, counts) + np.arange(total)
        ri = self.occ_read[idx].astype(np.int64)
        t = self.occ_t[idx].astype(np.int64)
        o = ccpos[pair_idx] - t
        keep = o >= 0
        return ri[keep], t[keep], o[keep]

    @staticmethod
    def _cell_keys(ri: np.ndarray, o: np.ndarray, t: np.ndarray
                   ) -> np.ndarray:
        assert o.size == 0 or int(o.max()) < (1 << 20)
        return (ri << np.int64(40)) | (o << np.int64(20)) | t

    def _build_base_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """Initial-snapshot match count per (read, offset, unit) cell —
        the expansion of every initial (kmer, pos) pair, counted per cell
        — as a sorted (key, count) lookup table."""
        if not self._init_sets or len(self.occ_kmer) == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        kmers = np.concatenate(list(self._init_sets.values()))
        ccpos = np.concatenate(
            [np.full(len(ks), pos, np.int64)
             for pos, ks in self._init_sets.items()])
        ri, t, o = self._expand(kmers, ccpos)
        if ri.size == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        keys, cnts = np.unique(self._cell_keys(ri, o, t),
                               return_counts=True)
        return keys, cnts.astype(np.int64)

    def apply_pairs(self, pairs: Sequence[Tuple[int, int]]):
        """Process newly frequent (kmer, cc_pos) pairs; returns touched
        read rows. Fully vectorized: occurrence expansion, per-cell count
        bookkeeping, S0/S1 scatter-adds, and the row-best refresh each run
        as single array passes over the batch."""
        if not len(pairs):
            return []
        kmers = np.fromiter((p[0] for p in pairs), np.int64, len(pairs))
        ccpos = np.fromiter((p[1] for p in pairs), np.int64, len(pairs))
        ri, t, o = self._expand(kmers, ccpos)
        if ri.size == 0:
            return []
        omax = int(o.max())
        if omax >= self.P:
            self._grow_P(omax)
        ucells, uinc = np.unique(self._cell_keys(ri, o, t),
                                 return_counts=True)
        uri = ucells >> np.int64(40)
        uo = (ucells >> np.int64(20)) & np.int64((1 << 20) - 1)

        # pre-update count per cell: the sorted cache tables where
        # present (main + pending are disjoint, so their probed values
        # sum), else the initial-snapshot base table
        in_main, idx_m, val_m = ArrayContig._probe(
            self._cnt_keys, self._cnt_vals, ucells)
        in_pend, idx_p, val_p = ArrayContig._probe(
            self._cnt_pkeys, self._cnt_pvals, ucells)
        cur = val_m + val_p
        miss = ~(in_main | in_pend)
        if miss.any():
            if len(self._base_keys):
                p = np.searchsorted(self._base_keys, ucells[miss])
                p = np.minimum(p, len(self._base_keys) - 1)
                hit = self._base_keys[p] == ucells[miss]
                cur[miss] = np.where(hit, self._base_vals[p], 0)
            else:
                cur[miss] = 0
        newv = cur + uinc
        if in_main.any():
            self._cnt_vals[idx_m[in_main]] = newv[in_main]
        if in_pend.any():
            self._cnt_pvals[idx_p[in_pend]] = newv[in_pend]
        if miss.any():
            at = np.searchsorted(self._cnt_pkeys, ucells[miss])
            self._cnt_pkeys = np.insert(self._cnt_pkeys, at, ucells[miss])
            self._cnt_pvals = np.insert(self._cnt_pvals, at, newv[miss])
            if len(self._cnt_pkeys) > ArrayContig._PENDING_CAP:
                keys = np.concatenate([self._cnt_keys, self._cnt_pkeys])
                vals = np.concatenate([self._cnt_vals, self._cnt_pvals])
                srt = np.argsort(keys, kind="stable")
                self._cnt_keys, self._cnt_vals = keys[srt], vals[srt]
                self._cnt_pkeys = np.empty(0, np.int64)
                self._cnt_pvals = np.empty(0, np.int64)

        # scatter the increments; several t cells may share one (r, o)
        flat = uri * np.int64(self.P) + uo
        np.add.at(self.S1.ravel(), flat, uinc.astype(np.int32))
        s0_inc = cur == 0
        if s0_inc.any():
            np.add.at(self.S0.ravel(), flat[s0_inc], np.int32(1))

        # refresh row-best caches from the touched (r, o) cells: per-row
        # max by (key, offset), then the same improve-only rule as the
        # sequential update (scores only ever increase)
        uflat = np.unique(flat)
        rows = uflat // np.int64(self.P)
        offs = uflat % np.int64(self.P)
        key = self._valid_key(self.S0.ravel()[uflat],
                              self.S1.ravel()[uflat])
        srt = np.lexsort((offs, key, rows))
        r_s, k_s, o_s = rows[srt], key[srt], offs[srt]
        last = np.nonzero(np.r_[r_s[1:] != r_s[:-1], True])[0]
        rr, bk, bo = r_s[last], k_s[last], o_s[last]
        upd = (bk > self._row_best_key[rr]) | \
            ((bk == self._row_best_key[rr]) & (bk >= 0)
             & (bo > self._row_best_pos[rr]))
        self._row_best_key[rr[upd]] = bk[upd]
        self._row_best_pos[rr[upd]] = bo[upd]
        return rows.tolist()

    # -- winner selection -------------------------------------------------

    def best_candidate(self) -> Optional[Tuple[str, int, Tuple[int, int]]]:
        """Lexicographic max of (score, position, -r_id) over unplaced
        reads; None when no valid candidate remains."""
        key = np.where(self.placed, _NEG, self._row_best_key)
        m = key.max() if key.size else _NEG
        if m < 0:
            return None
        rows = np.nonzero(key == m)[0]
        pos = self._row_best_pos[rows]
        best_pos = pos.max()
        rows = rows[pos == best_pos]
        ri = rows[np.argmin(self.lex_rank[rows])]
        s0 = int(m >> np.int64(32))
        s1 = int(m & np.int64(0xFFFFFFFF))
        return self.ids[int(ri)], int(best_pos), (s0, s1)

    def mark_placed(self, r_id: str):
        self.placed[self.ids.index(r_id)] = True

    # -- the greedy loop --------------------------------------------------

    def run(self) -> Tuple[Dict[str, Optional[int]],
                           Dict[str, Tuple[int, int]]]:
        with span("placement_greedy"):
            t0 = time.perf_counter()
            placements: Dict[str, Optional[int]] = {}
            scores: Dict[str, Tuple[int, int]] = {}
            while not bool(self.placed.all()):
                best = self.best_candidate()
                if best is None:
                    for ri, r in enumerate(self.ids):
                        if not self.placed[ri]:
                            placements[r] = None
                    break
                r_id, pos, sc = best
                placements[r_id] = pos
                scores[r_id] = sc
                self.mark_placed(r_id)
                new_freq = self.contig.add_read(self.clouds[r_id],
                                                position=pos)
                self.apply_pairs(new_freq)
        secs = time.perf_counter() - t0
        logger.info("placement greedy loop %.3fs (%d of %d reads placed)",
                    secs, len(scores), len(self.ids))
        return placements, scores
