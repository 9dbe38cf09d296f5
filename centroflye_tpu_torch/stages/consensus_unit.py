"""Consensus unit ("unit*") reconstruction from read k-mers: the JAX
package's `stages/consensus_unit.py` in PyTorch.

Reference behavior (better_consensus_unit_reconstruction.py:129-190): count
all k=30-mers over the reads' tandem alignments, take the 3x|unit k-mers|
most frequent (ties by k-mer string), build a small nucleotide de Bruijn
graph, clean it (collapse nonbranching paths, remove tips), then purify:
protect the highest-coverage "guaranteed" edge and greedily delete the
lowest-coverage edge while the graph stays weakly connected — ideally
leaving a single cycle whose sequence is the consensus unit, finally rotated
into the phase of the input unit via an infix alignment against the doubled
sequence.

The k-mer counting runs on a torch device (ops/kmers.count_unique over
batches, tables merged on the device by rare_kmers.MergeForest; one
int64 key per k-mer: k = 30 gives 60-bit keys, below KEY_SENTINEL); the
graph surgery is host work on a purpose-built tiny multigraph (a few
thousand edges — the reference uses networkx here; this implementation
is self-contained).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from centroflye_tpu_torch.config import ConsensusUnitConfig
from centroflye_tpu_torch.io.encoding import encode_batch, kmer_strings
from centroflye_tpu_torch.ops.align_path import hw_locate
from centroflye_tpu_torch.ops.kmers import count_unique, table_to_numpy
from centroflye_tpu_torch.stages.rare_kmers import (
    _HASH_BITS, MergeForest, _kmer_keys, _occ_accumulate, _occ_mask)


def count_kmers_total(seqs: Sequence[str], k: int, *,
                      batch_rows: int = 64,
                      capacity: Optional[int] = None,
                      min_occurrences: int = 0,
                      device="cuda"):
    """Total k-mer occurrence counts across sequences, on `device`.
    Returns (codes uint64 sorted, counts int64).

    Tables stay ON DEVICE across the sweep (rare_kmers.MergeForest,
    per-batch-sized tables); only run counts (scalars) and the final
    table reach the host. min_occurrences > 1 drops k-mers whose hashed
    occurrence estimate is below the threshold (exact for every k-mer at
    or above it; collisions only over-count — see
    rare_kmers.read_kmer_table)."""
    if not seqs:
        return np.empty(0, np.uint64), np.empty(0, np.int64)

    def batches():
        # one GLOBAL padded width for the whole sweep, as in the JAX
        # package
        Lg = max((len(s) for s in seqs), default=1)
        Lg = max(256, -(-Lg // 256) * 256)
        for i in range(0, len(seqs), batch_rows):
            chunk = list(seqs[i:i + batch_rows])
            if len(chunk) < batch_rows and len(seqs) > batch_rows:
                chunk += [""] * (batch_rows - len(chunk))
            codes, lens = encode_batch(chunk, max_len=Lg)
            yield (torch.from_numpy(codes).to(device),
                   torch.from_numpy(lens).to(device), lens)

    occ_table = None
    if min_occurrences > 1:
        occ_table = torch.zeros(1 << _HASH_BITS, dtype=torch.int32,
                                device=device)
        for codes, lens, _ in batches():
            _occ_accumulate(occ_table, codes, lens, k=k)

    forest = MergeForest(sum(max(0, len(s) - k + 1) for s in seqs),
                         capacity)
    for codes, lens, lens_host in batches():
        win_b = int(np.maximum(
            lens_host.astype(np.int64) - k + 1, 0).sum())
        if occ_table is not None:
            keys, n_keep = _occ_mask(occ_table, codes, lens,
                                     min_occurrences, k=k)
            win_b = int(n_keep)
            if win_b == 0:
                continue
        else:
            keys = _kmer_keys(codes, lens, k)
        forest.count(lambda cap, keys=keys: count_unique(keys, capacity=cap),
                     win_b)

    acc = forest.fold()
    if acc is None:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    codes_u64, counts = table_to_numpy(*acc)
    return codes_u64, counts.astype(np.int64)


# ------------------------- tiny multigraph --------------------------------


class _MultiGraph:
    """Minimal directed multigraph over string nodes with per-edge sequence
    + coverage list; supports exactly the surgery the reconstruction needs."""

    def __init__(self):
        self.edges: Dict[int, Tuple[str, str, str, List[int]]] = {}
        self._next = 0
        self.out_edges: Dict[str, set] = {}
        self.in_edges: Dict[str, set] = {}

    def add_edge(self, u: str, v: str, seq: str, covs: List[int]) -> int:
        eid = self._next
        self._next += 1
        self.edges[eid] = (u, v, seq, covs)
        self.out_edges.setdefault(u, set()).add(eid)
        self.in_edges.setdefault(v, set()).add(eid)
        self.out_edges.setdefault(v, set())
        self.in_edges.setdefault(u, set())
        return eid

    def remove_edge(self, eid: int):
        u, v, _, _ = self.edges.pop(eid)
        self.out_edges[u].discard(eid)
        self.in_edges[v].discard(eid)

    def remove_node(self, node: str):
        for eid in list(self.out_edges.get(node, ())):
            self.remove_edge(eid)
        for eid in list(self.in_edges.get(node, ())):
            self.remove_edge(eid)
        self.out_edges.pop(node, None)
        self.in_edges.pop(node, None)

    def nodes(self) -> List[str]:
        return list(self.out_edges.keys())

    def n_nodes(self) -> int:
        return len(self.out_edges)

    def degree(self, node: str) -> Tuple[int, int]:
        return len(self.in_edges.get(node, ())), \
            len(self.out_edges.get(node, ()))

    def drop_isolated(self):
        for node in self.nodes():
            if not self.in_edges[node] and not self.out_edges[node]:
                self.out_edges.pop(node, None)
                self.in_edges.pop(node, None)

    def is_weakly_connected(self, ignore: Optional[int] = None) -> bool:
        # undirected reachability over current nodes with >= 1 edge
        adj: Dict[str, set] = {}
        nodes_with_edges = set()
        for eid, (u, v, _, _) in self.edges.items():
            if eid == ignore:
                continue
            adj.setdefault(u, set()).add(v)
            adj.setdefault(v, set()).add(u)
            nodes_with_edges.add(u)
            nodes_with_edges.add(v)
        if not nodes_with_edges:
            return True
        start = next(iter(nodes_with_edges))
        seen = {start}
        stack = [start]
        while stack:
            x = stack.pop()
            for y in adj.get(x, ()):
                if y not in seen:
                    seen.add(y)
                    stack.append(y)
        return seen >= nodes_with_edges

    # -- surgery ----------------------------------------------------------

    def collapse_nonbranching(self, k: int):
        """Merge nodes with in-degree == out-degree == 1 (reference
        better_consensus_unit_reconstruction.py:53-81 without colors)."""
        for node in self.nodes():
            if self.n_nodes() <= 1:
                break
            ind, outd = self.degree(node)
            if ind == 1 and outd == 1:
                (in_eid,) = self.in_edges[node]
                (out_eid,) = self.out_edges[node]
                if in_eid == out_eid:      # self-loop, leave
                    continue
                u, _, seq_in, cov_in = self.edges[in_eid]
                _, w, seq_out, cov_out = self.edges[out_eid]
                new_seq = seq_in + seq_out[-(len(seq_out) - k + 1):]
                new_cov = sorted(cov_in + cov_out)
                self.remove_edge(in_eid)
                self.remove_edge(out_eid)
                self.out_edges.pop(node, None)
                self.in_edges.pop(node, None)
                self.add_edge(u, w, new_seq, new_cov)

    def remove_tips(self):
        """Iteratively delete nodes with zero in- or out-degree (but not
        isolated ones), reference :38-51."""
        while True:
            doomed = []
            for node in self.nodes():
                ind, outd = self.degree(node)
                if ind == 0 and outd == 0:
                    continue
                if ind == 0 or outd == 0:
                    doomed.append(node)
            if not doomed:
                return
            for node in doomed:
                self.remove_node(node)

    def purify(self, k: int):
        """Greedy low-coverage deletion keeping weak connectivity
        (reference :83-119)."""
        def cov(eid):
            return min(self.edges[eid][3])

        # protect the highest-coverage guaranteed edge (unique out of its
        # source, unique into its target); ties by edge endpoints
        first = None
        for eid in sorted(self.edges,
                          key=lambda e: (-cov(e), self.edges[e][0],
                                         self.edges[e][1])):
            u, v, _, _ = self.edges[eid]
            if len(self.out_edges[u]) == 1 and len(self.in_edges[v]) == 1:
                first = eid
                break
        protected = self.edges[first] if first is not None else None
        if first is not None:
            self.remove_edge(first)

        while True:
            victim = None
            for eid in sorted(self.edges,
                              key=lambda e: (cov(e), self.edges[e][0],
                                             self.edges[e][1])):
                if self.is_weakly_connected(ignore=eid):
                    victim = eid
                    break
            if victim is None:
                break
            self.remove_edge(victim)
            self.drop_isolated()
            self.collapse_nonbranching(k)
        if protected is not None:
            self.add_edge(*protected)
        self.remove_tips()
        self.collapse_nonbranching(k)


def reconstruct_unit(
    seqs: Sequence[str],
    unit_seq: str,
    config: ConsensusUnitConfig | None = None,
    *,
    batch_rows: int = 64,
    device="cuda",
) -> str:
    """Rebuild the consensus unit (unit*) from read tandem alignments
    (reference better_consensus_unit_reconstruction.py:156-190). The
    k-mer count runs on `device`, the graph surgery on the host."""
    config = config or ConsensusUnitConfig()
    k = config.k
    doubled = unit_seq + unit_seq
    unit_kmers = {doubled[i:i + k] for i in range(len(unit_seq))}
    n_top = int(len(unit_kmers) * config.top_factor)

    # occurrence prefilter: the top 3|unit| k-mers at assembly coverage
    # have counts in the hundreds, while read errors mint tens of
    # millions of low-count k-mers; drop estimates < 8 up front and fall
    # back to exact-full counting if the survivors can't fill the top
    # set (superset-safe — see count_kmers_total)
    for min_occ in (8, 0):
        codes, counts = count_kmers_total(
            seqs, k, batch_rows=batch_rows, min_occurrences=min_occ,
            device=device)
        if len(codes) >= n_top or min_occ == 0:
            break

    # top-n selection in numpy (a Python sort of tens of millions of
    # k-mer strings costs minutes); ties at the threshold break by
    # k-mer string DESCENDING — the reference's sorted(..., reverse=True)
    # on (count, kmer) tuples (better_consensus_unit_reconstruction.py)
    if len(codes) > n_top:
        thr = int(np.partition(counts, -n_top)[-n_top])
        above = np.nonzero(counts > thr)[0]
        need = n_top - len(above)
        tie_idx = np.nonzero(counts == thr)[0]
        if need > 0 and len(tie_idx):
            tie_strs = np.asarray(kmer_strings(codes[tie_idx], k))
            sel_t = tie_idx[np.argsort(tie_strs)[::-1][:need]]
            sel = np.concatenate([above, sel_t])
        else:
            sel = above
    else:
        sel = np.arange(len(codes))
    strs = kmer_strings(codes[sel], k)
    order = sorted(zip(counts[sel].tolist(), strs), reverse=True)[:n_top]
    top = [(s, c) for c, s in order]

    g = _MultiGraph()
    for kmer, c in top:
        g.add_edge(kmer[:-1], kmer[1:], kmer, [int(c)])
    g.collapse_nonbranching(k)
    g.remove_tips()
    g.collapse_nonbranching(k)
    g.purify(k)

    if not g.edges:
        return unit_seq
    # the surviving component should be a single cycle; take the
    # lexicographically-first edge (reference sorts edge tuples, :178-181)
    eid = min(g.edges, key=lambda e: (g.edges[e][0], g.edges[e][1]))
    new_unit = g.edges[eid][2]
    new_unit = new_unit[:-(k - 1)]

    # rotate into the input unit's phase via an infix alignment of the unit
    # against the doubled candidate (reference :183-188)
    doubled_new = new_unit + new_unit
    _, start, _ = hw_locate(unit_seq, doubled_new)
    return doubled_new[start:start + len(new_unit)]
