"""Monomer-alphabet de Bruijn graph, iterative assembly and scaffolding.

Reference behavior (debruijn_graph.py:18-271 DeBruijnGraph; :321-374
iterative_graph; :377-485 scaffolding; :488-577 read-to-scaffold mapping and
pseudounit extraction): nodes are (k-1)-mers of monomer strings, edges carry
k-mers with coverage lists; nonbranching paths collapse with "unique edge"
coloring (length >= min_uniq_len AND median coverage <= max_uniq_cov);
contigs extend edges along unambiguous in/out paths; the graph is rebuilt for
k = min_k..max_k feeding previous contigs and complex-node (k+1)-mers back in.

Array-native redesign: monomer strings are int16 numpy arrays; a k-mer is
keyed by its raw bytes; frequent-k-mer counting uses a vectorized rolling
hash (uint64 polynomial with odd-base modular inverses) as an exact
prefilter followed by row-wise verification — O(total_monomers) numpy work
per k instead of the reference's per-window Python dict slicing (hot loop
#7, 301 graph rebuilds).

The port's copy of the JAX package's `mono/debruijn.py` (host numpy, no
device work), held against it by tests/test_torch_mono.py.
"""

from __future__ import annotations

import dataclasses
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from centroflye_tpu_torch.mono.monostring import MonoString, GAP

_B = np.uint64(0x9E3779B97F4A7C15 | 1)   # odd multiplicative base
_OFF = np.uint64(2)


def _inv_u64(a: np.uint64) -> np.uint64:
    """Multiplicative inverse of odd a modulo 2^64 (Newton iteration;
    uint64 wraparound is intentional)."""
    with np.errstate(over="ignore"):
        x = a
        for _ in range(6):
            x = x * (np.uint64(2) - a * x)
        return x


_B_INV = _inv_u64(_B)
_POW_CACHE: Dict = {}


def _geom_powers(base: np.uint64, n: int) -> np.ndarray:
    """[base^0 .. base^n] mod 2^64 by block doubling: log2(n) vector
    multiplies instead of np.multiply.accumulate's scalar uint64 loop.
    Cached and grown geometrically per base."""
    key = int(base)
    cached = _POW_CACHE.get(key)
    if cached is not None and len(cached) > n:
        return cached
    m = max(2 * n + 1, 1 << 12)
    with np.errstate(over="ignore"):
        p = np.empty(m, np.uint64)
        p[0] = 1
        p[1] = base
        filled = 2
        while filled < m:
            take = min(filled, m - filled)
            np.multiply(p[:take], p[filled - 1] * base,
                        out=p[filled:filled + take])
            filled += take
    _POW_CACHE[key] = p
    return p


def rolling_kmer_hashes(s: np.ndarray, k: int) -> Tuple[np.ndarray,
                                                        np.ndarray]:
    """(hashes, valid) for all k-windows of an int16 symbol array; windows
    containing GAP are invalid. Hash: sum (s[i+j]+2) * B^(j+i) * B^-i."""
    L = len(s)
    if L < k:
        return np.empty(0, np.uint64), np.empty(0, bool)
    with np.errstate(over="ignore"):
        vals = (s.astype(np.int64) + 2).astype(np.uint64)
        terms = vals * _geom_powers(_B, L)[:L]
        prefix = np.concatenate([[np.uint64(0)], np.cumsum(terms)])
        H = (prefix[k:] - prefix[:-k]) * _geom_powers(_B_INV, L)[:L - k + 1]
    bad = (s == GAP)
    cs = np.concatenate([[0], np.cumsum(bad.astype(np.int32))])
    valid = (cs[k:] - cs[:-k]) == 0
    return H, valid


def get_all_kmers(strings: Dict, k: int):
    """Exact k-mer counts + per-read locations over gap-free windows
    (reference debruijn_graph.py:274-283). strings: r_id -> int16 array or
    MonoString. Returns (Counter{bytes: count}, {bytes: [(r_id, pos)]})."""
    counts: Counter = Counter()
    locations: Dict[bytes, List[Tuple]] = defaultdict(list)
    for r_id, s in strings.items():
        arr = s.syms if isinstance(s, MonoString) else s
        if len(arr) < k:
            continue
        H, valid = rolling_kmer_hashes(arr, k)
        win = np.lib.stride_tricks.sliding_window_view(arr, k)
        for pos in np.nonzero(valid)[0].tolist():
            key = win[pos].tobytes()
            counts[key] += 1
            locations[key].append((r_id, pos))
    return counts, locations


def get_frequent_kmers(strings: Dict, k: int, min_mult: int = 5,
                       with_locations: bool = True):
    """Frequent k-mers via the rolling-hash prefilter (exact result):
    only hash-frequent windows are materialized and verified
    (reference get_frequent_kmers, debruijn_graph.py:312-318).

    The verification is VECTORIZED: all strings concatenate into one
    symbol plane (hit windows never cross read boundaries, so window
    reads off the plane equal per-read windows), hits sort by hash, and
    each equal-hash run certifies row equality against its first row in
    one numpy comparison — a true collision (different k-mers, equal
    hash) falls back to an exact per-run np.unique split, instead of
    the reference's per-window dict slicing (reference hot loop #7).
    with_locations=False skips building the per-hit (r_id, pos) lists
    (production k-sweep callers use only the counts)."""
    arrays = []
    r_ids = []
    for r_id, s in strings.items():
        arr = s.syms if isinstance(s, MonoString) else s
        if len(arr) < k:
            continue
        arrays.append(np.ascontiguousarray(arr, dtype=np.int16))
        r_ids.append(r_id)
    if not arrays:
        return {}, {}
    # one GAP-joined plane: a single rolling-hash call covers every
    # read, and windows spanning a read boundary invalidate themselves
    # (they contain the separator GAP) — no per-read Python loop at all
    sep = np.array([GAP], np.int16)
    plane = np.concatenate(
        [x for a in arrays for x in (a, sep)][:-1])
    bases = np.zeros(len(arrays), np.int64)
    if len(arrays) > 1:
        bases[1:] = np.cumsum(
            [len(a) + 1 for a in arrays[:-1]])
    H, valid = rolling_kmer_hashes(plane, k)
    offs_all = np.nonzero(valid)[0]
    flat = H[valid]
    uniq, counts = np.unique(flat, return_counts=True)
    freq_h = uniq[counts >= min_mult]
    if freq_h.size == 0:
        return {}, {}
    qi = np.searchsorted(freq_h, flat)
    qi = np.minimum(qi, freq_h.size - 1)
    mask = freq_h[qi] == flat
    if not mask.any():
        return {}, {}
    offs = offs_all[mask]
    hh = flat[mask]
    order = np.argsort(hh, kind="stable")
    offs, hh = offs[order], hh[order]
    # row verification on the narrowest plane the alphabet allows:
    # monomer alphabets fit int8, halving the gather + compare traffic
    if plane.size and -128 <= int(plane.min()) and int(plane.max()) < 128:
        cmp_plane = plane.astype(np.int8)
    else:
        cmp_plane = plane
    W = np.lib.stride_tricks.sliding_window_view(cmp_plane, k)[offs]
    rstart = np.concatenate(
        [[0], np.nonzero(hh[1:] != hh[:-1])[0] + 1])
    starts = np.concatenate([rstart, [hh.size]])
    # adjacent-row equality: equality is transitive, so a run is uniform
    # iff every consecutive pair matches — one contiguous compare, no
    # second gather of per-run representatives
    adj = np.empty(hh.size, np.bool_)
    adj[0] = True
    if hh.size > 1:
        # void-view rows compare as single memcmp values — no (N, k)
        # bool intermediate
        Wv = np.ascontiguousarray(W).view(
            np.dtype((np.void, W.shape[1] * W.itemsize)))[:, 0]
        adj[1:] = Wv[1:] == Wv[:-1]
        adj[rstart] = True
    frequent: Dict[bytes, int] = {}
    freq_pos: Dict[bytes, List[Tuple]] = {}
    if with_locations:
        ridx = np.searchsorted(bases, offs, side="right") - 1
        posv = offs - bases[ridx]

    def kmer_key(row_idx: int) -> bytes:
        o = int(offs[row_idx])
        return plane[o:o + k].tobytes()

    def emit(a: int, b: int, sel=None):
        n = (b - a) if sel is None else int(sel.sum())
        if n < min_mult:
            return
        key = kmer_key(a if sel is None else a + int(np.nonzero(sel)[0][0]))
        frequent[key] = frequent.get(key, 0) + n
        if with_locations:
            rs = ridx[a:b] if sel is None else ridx[a:b][sel]
            ps = posv[a:b] if sel is None else posv[a:b][sel]
            freq_pos.setdefault(key, []).extend(
                (r_ids[int(r)], int(p)) for r, p in zip(rs, ps))

    if bool(adj.all()):         # no collisions anywhere (the usual case)
        for a, b in zip(starts[:-1], starts[1:]):
            emit(int(a), int(b))
        return frequent, freq_pos
    for a, b in zip(starts[:-1], starts[1:]):
        a, b = int(a), int(b)
        if bool(adj[a + 1:b].all()):
            emit(a, b)
            continue
        # genuine 64-bit hash collision: exact split
        u, inv = np.unique(W[a:b], axis=0, return_inverse=True)
        for g in range(len(u)):
            emit(a, b, inv == g)
    return frequent, freq_pos


def count_specific_kmers(strings: Dict, k: int,
                         queries: Sequence[bytes]) -> Dict[bytes, int]:
    """Exact occurrence counts of the queried k-mers only (no global
    table): hash every valid window once, binary-search the sorted query
    hashes, and verify each candidate window against its query bytes —
    O(total_symbols + hits * k) numpy work. Serves the complex-node
    (k+1)-mer evidence pass (reference get_paths_thru_complex_nodes,
    debruijn_graph.py:286-309), which queries a handful of (k+1)-mers
    per round but previously paid a full per-window Python count of ALL
    (k+1)-mers."""
    out: Dict[bytes, int] = {key: 0 for key in queries}
    if not queries:
        return out
    qarrs = [np.frombuffer(key, dtype=np.int16) for key in queries]
    if any(len(q) != k for q in qarrs):
        raise ValueError("query length != k")
    with np.errstate(over="ignore"):
        qh = np.array(
            [((q.astype(np.int64) + 2).astype(np.uint64)
              * np.multiply.accumulate(
                  np.concatenate([[np.uint64(1)],
                                  np.full(k - 1, _B, np.uint64)]))
              ).sum(dtype=np.uint64) for q in qarrs], np.uint64)
    qsort = np.sort(qh)
    by_hash: Dict[int, List[int]] = defaultdict(list)
    for i, h in enumerate(qh.tolist()):
        by_hash[h].append(i)
    keys = list(queries)
    for r_id, s in strings.items():
        arr = s.syms if isinstance(s, MonoString) else s
        arr = np.ascontiguousarray(arr, dtype=np.int16)
        if len(arr) < k:
            continue
        H, valid = rolling_kmer_hashes(arr, k)
        idx = np.searchsorted(qsort, H)
        idx = np.minimum(idx, qsort.size - 1)
        m = valid & (qsort[idx] == H)
        if not m.any():
            continue
        win = np.lib.stride_tricks.sliding_window_view(arr, k)
        hits = np.nonzero(m)[0]
        for h in np.unique(H[hits]).tolist():
            ps = hits[H[hits] == h]
            rows = win[ps]
            for qi in by_hash[int(h)]:
                out[keys[qi]] += int(
                    np.all(rows == qarrs[qi][None, :], axis=1).sum())
    return out


def _key_to_arr(key: bytes) -> np.ndarray:
    return np.frombuffer(key, dtype=np.int16)


@dataclasses.dataclass
class Edge:
    u: int
    v: int
    syms: np.ndarray          # edge k-mer (monomer symbols)
    coverages: List[int]
    color: str = "black"

    @property
    def length(self) -> int:
        return len(self.coverages)


class MonoDeBruijnGraph:
    """De Bruijn graph over monomer symbol arrays (reference
    debruijn_graph.py:18-271)."""

    def __init__(self, k: int, max_uniq_cov: int = 60,
                 min_uniq_len: int = 1000):
        self.k = k
        self.max_uniq_cov = max_uniq_cov
        self.min_uniq_len = min_uniq_len
        self.node_ids: Dict[bytes, int] = {}
        self.edges: Dict[int, Edge] = {}
        self._next_edge = 0
        self.out_edges: Dict[int, set] = defaultdict(set)
        self.in_edges: Dict[int, set] = defaultdict(set)
        self._index: Optional[Dict[bytes, Tuple[int, int]]] = None

    # -- construction -----------------------------------------------------

    def _node(self, key: bytes) -> int:
        if key not in self.node_ids:
            nid = len(self.node_ids)
            self.node_ids[key] = nid
            self.out_edges[nid]
            self.in_edges[nid]
            return nid
        return self.node_ids[key]

    def add_kmer(self, kmer, coverage: int = 1):
        arr = _key_to_arr(kmer) if isinstance(kmer, bytes) \
            else np.asarray(kmer, dtype=np.int16)
        u = self._node(arr[:-1].tobytes())
        v = self._node(arr[1:].tobytes())
        eid = self._next_edge
        self._next_edge += 1
        self.edges[eid] = Edge(u=u, v=v, syms=arr.copy(),
                               coverages=[int(coverage)])
        self.out_edges[u].add(eid)
        self.in_edges[v].add(eid)

    def add_kmers(self, kmers, coverage=None):
        for kmer in kmers:
            cov = 1 if coverage is None else coverage[kmer]
            self.add_kmer(kmer, coverage=cov)

    # -- surgery ----------------------------------------------------------

    def _remove_edge(self, eid: int):
        e = self.edges.pop(eid)
        self.out_edges[e.u].discard(eid)
        self.in_edges[e.v].discard(eid)

    def collapse_nonbranching_paths(self):
        """Merge in/out-degree-1 nodes; merged edges get the unique (blue)
        color when len >= min_uniq_len and median coverage <= max_uniq_cov
        (reference :79-114)."""
        self._index = None
        for node in list(self.out_edges.keys()):
            if len(self.node_ids) <= 1:
                break
            ins = self.in_edges[node]
            outs = self.out_edges[node]
            if len(ins) == 1 and len(outs) == 1:
                (in_eid,) = ins
                (out_eid,) = outs
                if in_eid == out_eid:
                    continue
                a = self.edges[in_eid]
                b = self.edges[out_eid]
                new_syms = np.concatenate(
                    [a.syms, b.syms[-(len(b.syms) - self.k + 1):]])
                covs = sorted(a.coverages + b.coverages)
                # np.median of the sorted list, without numpy's per-call
                # cost: the merge runs once a node and round
                h = len(covs) // 2
                med = (float(covs[h]) if len(covs) % 2
                       else (covs[h - 1] + covs[h]) / 2)
                length = len(covs)
                color = "blue" if (length + self.k - 1 >= self.min_uniq_len
                                   and med <= self.max_uniq_cov) else "black"
                u, v = a.u, b.v
                self._remove_edge(in_eid)
                self._remove_edge(out_eid)
                eid = self._next_edge
                self._next_edge += 1
                self.edges[eid] = Edge(u=u, v=v, syms=new_syms,
                                       coverages=covs, color=color)
                self.out_edges[u].add(eid)
                self.in_edges[v].add(eid)

    # -- queries ----------------------------------------------------------

    def get_edges(self):
        """(contig symbol arrays, median coverages) of all edges after a
        collapse (reference :116-122)."""
        self.collapse_nonbranching_paths()
        contigs, coverages = [], []
        for e in self.edges.values():
            contigs.append(e.syms)
            coverages.append(float(np.median(e.coverages)))
        return contigs, coverages

    def write_dot(self, path: str) -> None:
        """Graphviz dump of the collapsed graph (the reference writes
        db_k{k}.dot per k-sweep round via networkx,
        debruijn_graph.py:359-361); edges carry length / median coverage /
        the unique-edge color."""
        import os
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            print("digraph {", file=f)
            for nid in sorted(set(self.node_ids.values())):
                print(f"  n{nid};", file=f)
            for eid in sorted(self.edges):
                e = self.edges[eid]
                cov = float(np.median(e.coverages)) if e.coverages else 0.0
                print(f'  n{e.u} -> n{e.v} [label="e{eid} len={e.length} '
                      f'cov={cov:.1f}", color={e.color}];', file=f)
            print("}", file=f)

    def get_path(self, edge_ids: Sequence[int]) -> np.ndarray:
        """Concatenate an edge path's symbols, k-1 overlap collapsed;
        cyclic paths drop the duplicated (k-1)-suffix (reference :124-135)."""
        parts = [self.edges[edge_ids[0]].syms]
        for prev_eid, eid in zip(edge_ids[:-1], edge_ids[1:]):
            e = self.edges[eid]
            prev = self.edges[prev_eid]
            assert np.array_equal(prev.syms[-(self.k - 1):],
                                  e.syms[:self.k - 1])
            parts.append(e.syms[self.k - 1:])
        path = np.concatenate(parts)
        if self.edges[edge_ids[0]].u == self.edges[edge_ids[-1]].v:
            path = path[:-(self.k - 1)]
        return path

    def get_edgepath2coords(self, edge_ids: Sequence[int]):
        """(edge_index, offset_in_edge) -> coordinate in the concatenated
        path (reference :137-149)."""
        coords = {}
        str_coord = 0
        for i, eid in enumerate(edge_ids):
            e = self.edges[eid]
            for j in range(len(e.syms)):
                coords[(i, j)] = str_coord
                str_coord += 1
            str_coord -= self.k - 1
        return coords

    def get_contigs(self):
        """Contigs = maximal unambiguous edge paths (reference :151-224).
        Returns (list of symbol arrays, list of edge-id path tuples)."""
        self.collapse_nonbranching_paths()

        def longest_valid_outpath(eid, out_edges, edge_dst):
            path = [eid]
            taken = {eid}
            cur = edge_dst(eid)
            while True:
                outs = out_edges[cur]
                if len(outs) != 1:
                    break
                (nxt,) = outs
                if nxt in taken:
                    break
                path.append(nxt)
                taken.add(nxt)
                cur = edge_dst(nxt)
            return path

        outpaths = {eid: longest_valid_outpath(
            eid, self.out_edges, lambda e: self.edges[e].v)
            for eid in self.edges}
        inpaths = {eid: longest_valid_outpath(
            eid, self.in_edges, lambda e: self.edges[e].u)[::-1]
            for eid in self.edges}

        valid_paths = set()
        for eid in self.edges:
            path = list(inpaths[eid])
            seen = set(path)
            for e in outpaths[eid][1:]:
                if e in seen:
                    break
                path.append(e)
                seen.add(e)
            valid_paths.add(tuple(path))
        valid_paths = list(valid_paths)

        # drop paths that are subpaths of others
        selected = []
        for p1 in valid_paths:
            dup = False
            for p2 in valid_paths:
                if p1 == p2:
                    continue
                for i in range(len(p2) - len(p1) + 1):
                    if p1 == p2[i:i + len(p1)]:
                        dup = True
                        break
                if dup:
                    break
            if not dup:
                selected.append(p1)

        contigs = []
        seen_keys = set()
        paths = []
        for p in selected:
            arr = self.get_path(p)
            key = arr.tobytes()
            if key not in seen_keys:
                seen_keys.add(key)
                contigs.append(arr)
                paths.append(list(p))
        return contigs, paths

    # -- read mapping ------------------------------------------------------

    def index_edges(self) -> Dict[bytes, Tuple[int, int]]:
        """Unique full-k sub-k-mer index of edges: kmer -> (edge_id, offset)
        (reference index_edges :60-77, restricted to length k — map_reads
        only queries full-length k-mers, :240-246)."""
        if self._index is not None:
            return self._index
        counts: Dict[bytes, List[Tuple[int, int]]] = defaultdict(list)
        for eid, e in self.edges.items():
            win = np.lib.stride_tricks.sliding_window_view(e.syms, self.k) \
                if len(e.syms) >= self.k else np.empty((0, self.k), np.int16)
            for off in range(win.shape[0]):
                counts[win[off].tobytes()].append((eid, off))
        self._index = {key: pos[0] for key, pos in counts.items()
                       if len(pos) == 1}
        return self._index

    def map_reads(self, monoreads: Dict[str, MonoString]):
        """Map reads by unique k-mer hits -> edge paths with a validity
        check (reference map_reads :226-263). Returns
        {r_id: ((first_hit, first_pos), (last_hit, last_pos), valid, path)}
        where hits are (edge_id, offset) and path is a list of edge ids."""
        index = self.index_edges()
        mapping = {}
        for r_id, m in monoreads.items():
            arr = m.syms if isinstance(m, MonoString) else m
            coords = []
            if len(arr) >= self.k:
                win = np.lib.stride_tricks.sliding_window_view(arr, self.k)
                _, valid = rolling_kmer_hashes(arr, self.k)
                for pos in np.nonzero(valid)[0].tolist():
                    hit = index.get(win[pos].tobytes())
                    if hit is not None:
                        coords.append((hit, pos))
            path = []
            for (eid, _), _pos in coords:
                if not path or path[-1] != eid:
                    path.append(eid)
            valid_path = all(
                self.edges[e1].v == self.edges[e2].u
                for e1, e2 in zip(path[:-1], path[1:]))
            mapping[r_id] = (coords[0], coords[-1], valid_path, path) \
                if coords else None
        return mapping

    def get_long_edges(self) -> Dict[int, np.ndarray]:
        """Unique (blue) edges (reference :265-271)."""
        return {eid: e.syms for eid, e in self.edges.items()
                if e.color == "blue"}
