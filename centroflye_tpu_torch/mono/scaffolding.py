"""Iterative graph assembly + scaffolding of monomer reads.

Reference behavior:
- iterative_graph (debruijn_graph.py:321-374): rebuild the de Bruijn graph
  for k = min_k..max_k, each round feeding previous contigs (x min_mult
  copies) and complex-node (k+1)-mer evidence back into the string set.
- get_paths_thru_complex_nodes (:286-309): (k+1)-mers spanning >1-in/>1-out
  nodes with enough read support.
- scaffolding (:377-485): count read-path connections between unique (blue)
  edges, build a scaffold DAG from pairs with >= min_connections support,
  take the longest path per component, expand with the best-supported
  connection paths and the longest read extensions.
- read2scaffolds (:488-512), cover_scaffolds_w_reads (:515-532),
  partition_pseudounits (:535-551), extract_read_pseudounits (:554-577),
  polish (:580-649 — per-pseudounit Flye subprocesses, replaced here by the
  in-repo consensus polisher).

The port's copy of the JAX package's `mono/scaffolding.py` (host numpy, no
device work), held against it by tests/test_torch_mono.py.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from centroflye_tpu_torch.mono.debruijn import (
    MonoDeBruijnGraph, count_specific_kmers, get_frequent_kmers,
)
from centroflye_tpu_torch.mono.monostring import MonoString, GAP


def get_complex_nodes(db: MonoDeBruijnGraph) -> List[int]:
    return [node for node in db.out_edges
            if len(db.in_edges[node]) > 1 and len(db.out_edges[node]) > 1]


def get_paths_thru_complex_nodes(db: MonoDeBruijnGraph, strings,
                                 min_mult: int = 2) -> Dict[bytes, int]:
    """(k+1)-mer evidence through complex nodes (reference :286-309)."""
    complex_nodes = set(get_complex_nodes(db))
    if not complex_nodes:
        return {}
    k = db.k
    wanted: List[bytes] = []
    for node in complex_nodes:
        for in_eid in db.in_edges[node]:
            for out_eid in db.out_edges[node]:
                in_tail = db.edges[in_eid].syms[-k:]
                out_head = db.edges[out_eid].syms[:k]
                assert np.array_equal(in_tail[1:], out_head[:-1])
                kp1 = np.concatenate([in_tail, out_head[-1:]])
                wanted.append(kp1.tobytes())
    # count ONLY the queried (k+1)-mers — the full (k+1)-mer table the
    # reference builds here (debruijn_graph.py:274-283) costs a
    # per-window pass over every read each round for a handful of keys
    counts = count_specific_kmers(strings, k + 1, wanted)
    return {key: c for key, c in counts.items() if c >= min_mult}


def iterative_graph(monoreads: Dict[str, MonoString], min_k: int,
                    max_k: int, min_mult: int = 5, step: int = 1,
                    max_uniq_cov: int = 60, min_uniq_len: int = 1000,
                    verbose: bool = False, outdir: str = None):
    """k-sweep assembly (reference iterative_graph :321-374). Returns
    (all_contigs {k: [arrays]}, dbs {k: graph}). With `outdir`, dumps
    db_k{k}.dot per round (reference debruijn_graph.py:359-361)."""
    strings = {r_id: m.syms for r_id, m in monoreads.items()}
    input_strings = dict(strings)
    complex_kp1: Dict[bytes, int] = {}
    all_contigs: Dict[int, List[np.ndarray]] = {}
    dbs: Dict[int, MonoDeBruijnGraph] = {}

    for k in range(min_k, max_k + 1, step):
        frequent, _ = get_frequent_kmers(input_strings, k=k,
                                         min_mult=min_mult,
                                         with_locations=False)
        # complex (k+1)-mers from the previous round ride along (their
        # length is previous k+1 == current k when step == 1)
        for key, cnt in complex_kp1.items():
            if len(np.frombuffer(key, np.int16)) == k:
                frequent[key] = cnt
        if verbose:
            print(f"k={k}: {len(frequent)} frequent kmers")
        db = MonoDeBruijnGraph(k=k, max_uniq_cov=max_uniq_cov,
                               min_uniq_len=min_uniq_len)
        db.add_kmers(frequent, coverage=frequent)
        db.collapse_nonbranching_paths()
        dbs[k] = db
        if outdir is not None:
            import os
            db.write_dot(os.path.join(outdir, f"db_k{k}.dot"))
        contigs, _paths = db.get_contigs()
        all_contigs[k] = contigs

        input_strings = dict(strings)
        for i, contig in enumerate(contigs):
            for j in range(min_mult):
                input_strings[f"contig_k{k}_i{i}_j{j}"] = contig
        complex_kp1 = get_paths_thru_complex_nodes(db, strings)
    return all_contigs, dbs


# ------------------------------ scaffolding -------------------------------


def scaffolding(db: MonoDeBruijnGraph, mappings,
                min_connections: int = 2, additional_edges=(),
                outdir: str = None):
    """Scaffold unique edges with read-path support (reference :377-485).
    Returns (scaffold symbol arrays, scaffold edge-id paths). With
    `outdir`, dumps scaffold_graph.dot (reference debruijn_graph.py:480)."""
    long_edge_ids = set(db.get_long_edges().keys()) | set(additional_edges)

    # connections[(e1, e2)][connection-path] = support count
    connections: Dict[Tuple[int, int], Counter] = defaultdict(Counter)
    for r_id, mapping in mappings.items():
        if mapping is None:
            continue
        _, _, valid_path, path = mapping
        if not valid_path:
            continue
        inters = set(path) & long_edge_ids
        if len(inters) > 1:
            indexes = sorted(path.index(e) for e in inters)
            for i, j in zip(indexes[:-1], indexes[1:]):
                pair = (path[i], path[j])
                connections[pair][tuple(path[i:j + 1])] += 1

    # scaffold graph over long edges
    nodes = set(db.get_long_edges().keys())
    sg_edges: Dict[Tuple[int, int], Counter] = {}
    for (e1, e2), conn in connections.items():
        if sum(conn.values()) >= min_connections:
            sg_edges[(e1, e2)] = conn

    if outdir is not None:
        import os
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, "scaffold_graph.dot"), "w") as f:
            print("digraph {", file=f)
            for nid in sorted(nodes):
                print(f"  e{nid};", file=f)
            for (e1, e2), conn in sorted(sg_edges.items()):
                print(f'  e{e1} -> e{e2} '
                      f'[label="support={sum(conn.values())}"];', file=f)
            print("}", file=f)

    # weakly connected components + DAG longest path per component
    adj = defaultdict(set)
    for (e1, e2) in sg_edges:
        adj[e1].add(e2)
        adj[e2].add(e1)
        nodes.add(e1)
        nodes.add(e2)
    seen = set()
    components = []
    for start in sorted(nodes):
        if start in seen:
            continue
        comp = {start}
        stack = [start]
        seen.add(start)
        while stack:
            x = stack.pop()
            for y in adj[x]:
                if y not in seen:
                    seen.add(y)
                    comp.add(y)
                    stack.append(y)
        components.append(comp)

    def dag_longest_path(comp):
        out = defaultdict(list)
        indeg = Counter()
        comp_edges = [(a, b) for (a, b) in sg_edges if a in comp]
        for a, b in comp_edges:
            out[a].append(b)
            indeg[b] += 1
        # topological sort (returns None on cycle)
        order = [n for n in sorted(comp) if indeg[n] == 0]
        top = []
        indeg = dict(indeg)
        queue = list(order)
        while queue:
            n = queue.pop(0)
            top.append(n)
            for m in out[n]:
                indeg[m] -= 1
                if indeg[m] == 0:
                    queue.append(m)
        if len(top) != len(comp):
            return None  # cyclic component: skipped (reference :419-423)
        best_len = {n: 0 for n in comp}
        best_prev = {n: None for n in comp}
        for n in top:
            for m in out[n]:
                if best_len[n] + 1 > best_len[m]:
                    best_len[m] = best_len[n] + 1
                    best_prev[m] = n
        end = max(comp, key=lambda n: (best_len[n], n))
        path = [end]
        while best_prev[path[-1]] is not None:
            path.append(best_prev[path[-1]])
        return path[::-1]

    longedge_scaffolds = []
    for comp in components:
        p = dag_longest_path(comp)
        if p is not None:
            longedge_scaffolds.append(p)

    def longest_extensions(scaffold):
        left_edge, right_edge = scaffold[0], scaffold[-1]
        best_left: List[int] = []
        best_right: List[int] = []
        for r_id, mapping in mappings.items():
            if mapping is None:
                continue
            _, _, valid_path, path = mapping
            if not valid_path:
                continue
            if left_edge in path:
                li = path.index(left_edge)
                if li > len(best_left):
                    best_left = path[:li]
            if right_edge in path:
                ri = path.index(right_edge)
                ext = path[ri + 1:]
                if len(ext) > len(best_right):
                    best_right = ext
        return best_left, best_right

    edge_scaffolds = []
    for scaffold in longedge_scaffolds:
        edge_scaffold = [scaffold[0]]
        for e1, e2 in zip(scaffold[:-1], scaffold[1:]):
            conn = sg_edges[(e1, e2)]
            best_path = max(sorted(conn), key=lambda p: conn[p])
            edge_scaffold += list(best_path[1:])
        left_ext, right_ext = longest_extensions(scaffold)
        edge_scaffolds.append(left_ext + edge_scaffold + right_ext)

    scaffolds = [db.get_path(es) for es in edge_scaffolds]
    return scaffolds, edge_scaffolds


def _kmp_overlap(a: np.ndarray, b: np.ndarray, min_overlap: int) -> int:
    """Longest exact overlap: suffix of `a` == prefix of `b` (monomer
    symbols), via the prefix-function of b + SEP + a. Returns 0 when
    below min_overlap."""
    if len(a) == 0 or len(b) == 0:
        return 0
    sep = np.int16(-32000)            # outside any symbol alphabet
    s = np.concatenate([b, [sep], a]).tolist()
    n = len(s)
    pi = [0] * n
    k = 0
    for i in range(1, n):
        while k > 0 and s[i] != s[k]:
            k = pi[k - 1]
        if s[i] == s[k]:
            k += 1
        pi[i] = k
    ov = pi[-1]
    return ov if ov >= min_overlap else 0


def merge_overlapping_scaffolds(scaffolds: List[np.ndarray],
                                min_overlap: int = 50
                                ) -> List[np.ndarray]:
    """Automated scaffold join: the reference ends cen6 by MANUALLY
    concatenating scaffolds 0 and 1 (reference centroFlyeMono.py:84-87,
    a hard-coded "# TODO" join). Here collinear scaffolds are joined on
    EVIDENCE: repeatedly merge the pair with the longest exact
    suffix-prefix monomer overlap (>= min_overlap monomers, ~8.5 kb of
    nucleotides at cen6's monomer size — far beyond chance), dropping
    scaffolds wholly contained in another first. Exact containment and
    overlap only — no forced concatenation, so a genuine gap stays a
    gap."""
    scafs = [np.asarray(s, np.int16) for s in scaffolds if len(s)]
    # containment: drop scaffolds that appear inside a longer one
    scafs.sort(key=len, reverse=True)
    kept: List[np.ndarray] = []
    for s in scafs:
        sb = s.tobytes()
        contained = False
        for t in kept:
            tb = t.tobytes()
            p = tb.find(sb)
            while p >= 0:
                if p % 2 == 0:        # int16 alignment check
                    contained = True
                    break
                p = tb.find(sb, p + 1)
            if contained:
                break
        if not contained:
            kept.append(s)
    merged = True
    while merged and len(kept) > 1:
        merged = False
        best = (0, -1, -1)
        for i in range(len(kept)):
            for j in range(len(kept)):
                if i == j:
                    continue
                ov = _kmp_overlap(kept[i], kept[j], min_overlap)
                if ov > best[0]:
                    best = (ov, i, j)
        ov, i, j = best
        if ov > 0:
            joined = np.concatenate([kept[i], kept[j][ov:]])
            kept = [s for q, s in enumerate(kept) if q not in (i, j)]
            kept.append(joined)
            merged = True
    kept.sort(key=len, reverse=True)
    return kept


def merge_scaffolds_with_paths(db: MonoDeBruijnGraph,
                               scaffolds: List[np.ndarray],
                               edge_scaffolds: List[List[int]],
                               min_overlap: int = 50):
    """Evidence-joined scaffolds WITH graph edge paths: symbol-level
    exact-overlap merging (merge_overlapping_scaffolds) whose every
    accepted merge is re-anchored through the graph — the merged symbol
    run is mapped back to a VALID edge path (db.map_reads on the
    symbols) and its sequence re-derived with db.get_path, so the
    (scaffold, edge path) pair keeps the exact invariants scaffolding()
    established and the downstream read2scaffolds /
    cover_scaffolds_w_reads coordinate math is unchanged. A merge whose
    symbols do not map to one valid path is rejected (kept split).
    Returns (scaffolds, edge_scaffolds)."""
    items = [(np.asarray(s, np.int16), list(p))
             for s, p in zip(scaffolds, edge_scaffolds) if len(s)]
    items.sort(key=lambda t: len(t[0]), reverse=True)
    kept: List[Tuple[np.ndarray, List[int]]] = []
    for s, p in items:
        sb = s.tobytes()
        contained = False
        for t, _ in kept:
            tb = t.tobytes()
            q = tb.find(sb)
            while q >= 0 and not contained:
                if q % 2 == 0:
                    contained = True
                q = tb.find(sb, q + 1)
            if contained:
                break
        if not contained:
            kept.append((s, p))
    banned = set()
    while len(kept) > 1:
        cands = []
        for i in range(len(kept)):
            for j in range(len(kept)):
                if i == j or (i, j) in banned:
                    continue
                ov = _kmp_overlap(kept[i][0], kept[j][0], min_overlap)
                if ov > 0:
                    cands.append((ov, i, j))
        cands.sort(reverse=True)
        merged_any = False
        for ov, i, j in cands:
            merged_sym = np.concatenate([kept[i][0], kept[j][0][ov:]])
            m = db.map_reads({"m": merged_sym}).get("m")
            if m is None or not m[2] or not m[3]:
                banned.add((i, j))
                continue
            path = m[3]
            sym = db.get_path(path)
            if len(sym) <= max(len(kept[i][0]), len(kept[j][0])):
                banned.add((i, j))
                continue
            kept = [t for q, t in enumerate(kept) if q not in (i, j)]
            kept.append((sym, path))
            banned = set()
            merged_any = True
            break
        if not merged_any:
            break
    kept.sort(key=lambda t: len(t[0]), reverse=True)
    return [s for s, _ in kept], [p for _, p in kept]


def read2scaffolds(db: MonoDeBruijnGraph, scaffold_paths, mappings,
                   monoreads):
    """Unique placement of each read path inside a scaffold path ->
    monomer-coordinate span (reference :488-512)."""
    coords_per_scaffold = [db.get_edgepath2coords(p) for p in scaffold_paths]
    r2s: Dict[str, List[Tuple[int, int, int]]] = defaultdict(list)
    for r_id, mapping in mappings.items():
        if mapping is None:
            continue
        (e_st, r_st), (e_en, r_en), valid_path, read_path = mapping
        if not valid_path:
            continue
        for sc_index, spath in enumerate(scaffold_paths):
            coords = coords_per_scaffold[sc_index]
            for i in range(len(spath) - len(read_path) + 1):
                if spath[i:i + len(read_path)] == read_path:
                    r2s[r_id].append((
                        sc_index,
                        coords[(i, e_st[1])],
                        coords[(i + len(read_path) - 1,
                                e_en[1] + db.k - 1)]))
    return {r: v[0] for r, v in r2s.items() if len(v) == 1}


def cover_scaffolds_w_reads(r2s, mappings, scaffold_seqs, monoreads,
                            k: int):
    """Per scaffold monomer position: covering reads and their nucleotide
    coordinates (reference :515-532)."""
    coverage = [[{} for _ in range(len(seq))] for seq in scaffold_seqs]
    for r_id, (scaf_id, s_st, s_en) in r2s.items():
        (_, r_st), (_, r_en), valid_path, _ = mappings[r_id]
        if not valid_path:
            continue
        if s_en - s_st != r_en - r_st + k - 1:
            continue
        m = monoreads[r_id]
        cov = coverage[scaf_id]
        for i in range(s_en - s_st + 1):
            rp = r_st + i
            if rp < len(m) and m.syms[rp] != GAP and m.nucl[rp, 0] >= 0:
                cov[s_st + i][r_id] = (int(m.syms[rp]),
                                       int(m.nucl[rp, 0]),
                                       int(m.nucl[rp, 1]))
    return coverage


def partition_pseudounits(scaffold: np.ndarray) -> List[Tuple[int, int]]:
    """Greedy maximal blocks without a repeated monomer (reference
    :535-551). Returns [(start, end_inclusive)]."""
    pseudounits = []
    i = 0
    L = len(scaffold)
    while i < L:
        seen = set()
        j = 0
        while i + j < L:
            sym = int(scaffold[i + j])
            if sym in seen:
                break
            seen.add(sym)
            j += 1
        pseudounits.append((i, i + j - 1))
        i += j
    return pseudounits


def extract_read_pseudounits(scaf_read_coverage, scaffold_seqs, monoreads,
                             min_coverage: int = 0):
    """Per pseudounit: reads covering both its ends and their nucleotide
    spans (reference :554-577)."""
    read_pseudounits, pseudounits = [], []
    for i, seq in enumerate(scaffold_seqs):
        scaf_units = partition_pseudounits(seq)
        pseudounits.append(scaf_units)
        sr_cov = scaf_read_coverage[i]
        per_scaf = []
        for (u_st, u_en) in scaf_units:
            s_cov = sr_cov[u_st]
            e_cov = sr_cov[u_en]
            r_ids = set(s_cov) & set(e_cov)
            if len(r_ids) < min_coverage:
                continue
            unit_reads = {}
            for r_id in r_ids:
                coords = [s_cov[r_id][1], s_cov[r_id][2],
                          e_cov[r_id][1], e_cov[r_id][2]]
                st, en = min(coords), max(coords)
                strand = monoreads[r_id].strand
                unit_reads[r_id] = (st, en, strand)
            per_scaf.append(unit_reads)
        read_pseudounits.append(per_scaf)
    return pseudounits, read_pseudounits


def polish_scaffolds(scaffolds, pseudounits, read_pseudounits, reads,
                     n_iter: int = 2):
    """Per-pseudounit consensus polishing over raw nucleotide reads
    (in-repo replacement for the reference's per-pseudounit Flye
    subprocesses, :580-649: reads covering the pseudounit are collected
    (RC'd for '-' strand), the median-high-length one is the template).
    Returns the polished scaffold sequences."""
    from centroflye_tpu_torch.io.encoding import revcomp_str
    from centroflye_tpu_torch.stages.consensus import polish_consensus
    from centroflye_tpu_torch.stages.polisher import median_high

    polished_scaffolds = []
    for i, (scaffold, scaf_units) in enumerate(zip(scaffolds, pseudounits)):
        parts = []
        for j, (s_st, s_en) in enumerate(scaf_units):
            if j >= len(read_pseudounits[i]):
                continue
            unit_reads = {}
            for r_id, (r_st, r_en, strand) in read_pseudounits[i][j].items():
                base_id = r_id[0] if isinstance(r_id, tuple) else r_id
                seq = reads[base_id][r_st:r_en + 1]
                if strand == "-":
                    seq = revcomp_str(seq)
                unit_reads[f"s_{i}_t_{j}_{base_id}_{r_st}_{r_en + 1}"] = seq
            if not unit_reads:
                continue
            lens = [len(s) for s in unit_reads.values()]
            med = median_high(lens)
            template = None
            for tag in sorted(unit_reads):
                if len(unit_reads[tag]) == med:
                    template = unit_reads[tag]
                    break
            polished = polish_consensus(template, list(unit_reads.values()),
                                        n_iters=n_iter)
            parts.append(polished[n_iter])
        polished_scaffolds.append("".join(parts))
    return polished_scaffolds
