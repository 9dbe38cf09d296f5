"""Rare k-mer recruitment (stage 1 of unique-k-mer selection), the JAX
package's `stages/rare_kmers.py` in PyTorch.

Reference behavior (distance_based_kmer_recruitment.py:39-82): count k=19-mers
over each read's tandem alignment; a k-mer is discarded once it occurs more
than once within a read in more than max_nonuniq=3 reads; surviving k-mers
keep frequency = number of reads containing them; "rare" k-mers are those
with frequency in [bottom*coverage*survival_rate, top*coverage*survival_rate].

The reference's sequential dict accumulation is order-independent in its
final result (a k-mer survives iff |{reads with in-read freq > 1}| <=
max_nonuniq, with frequency |{reads containing it}|), which is exactly what
ops/kmers.count_read_kmer_stats computes by sort/segment-reduce — so this
stage is a batched device computation with an associative cross-batch
merge. Tables stay on the device; only run counts (scalars) and the final
table reach the host.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from centroflye_tpu_torch.config import KmerRecruitmentConfig
from centroflye_tpu_torch.io.encoding import encode_batch
from centroflye_tpu_torch.ops.kmers import (
    KEY_SENTINEL, MASK, count_read_kmer_stats, join_keys,
    merge_count_tables, pack_kmers, table_to_numpy,
)

logger = logging.getLogger("centroflye_tpu_torch")


def _iter_batches(seqs: Sequence[str], batch_rows: int, pad_to: int,
                  window_budget: int = 1 << 24):
    """Length-tiered batches: rows always batch_rows (empty-padded),
    columns the BATCH's own max length rounded up to a power of two
    (floored at pad_to). Reads are visited longest-first so each batch
    is length-homogeneous — padding waste is bounded by 2x instead of
    the max/mean ratio of the corpus (a rel2-like heavy-tailed mix has
    a ~150 kb max over a ~14 kb mean: global-max padding burns ~10x
    the device windows on every pass). Column dims are powers of two,
    so shape variety is log-bounded. Yields (row_ids, codes, lens) —
    row_ids are ORIGINAL sequence indices (the length sort permutes
    visit order; k-mer read-counts are id-agnostic but callers tag
    rows by original position).

    Row count per batch adapts to the tier: each batch targets
    ~`window_budget` padded elements, so short-read tiers pack
    thousands of rows per batch instead of `batch_rows` (the floor).
    Rows are powers of two, so (rows, cols) shape variety stays
    log-bounded."""
    order = sorted(range(len(seqs)), key=lambda i: -len(seqs[i]))
    b0 = 0
    while b0 < len(order):
        L0 = max(len(seqs[order[b0]]), 1)
        Lp = max(pad_to, 1 << int(np.ceil(np.log2(L0))))
        rows = max(batch_rows, 1 << max(0, int(np.log2(
            max(window_budget // Lp, 1)))))
        idx = order[b0:b0 + rows]
        chunk = [seqs[i] for i in idx]
        # rows were sized for the tier leader; keep the batch's own max
        # (later rows are shorter — never wider)
        L = max((len(s) for s in chunk), default=1)
        L = max(pad_to, 1 << int(np.ceil(np.log2(max(L, 1)))))
        ids = np.asarray(idx, np.int32)
        if len(chunk) < rows and len(order) > rows:
            ids = np.concatenate([
                ids, np.zeros(rows - len(chunk), np.int32)])
            chunk += [""] * (rows - len(chunk))
        codes, lens = encode_batch(chunk, max_len=L)
        yield ids, codes, lens
        b0 += rows


_HASH_BITS = 26
_HASH_MULT = 0x9E3779B1


def _occ_hash(keys: torch.Tensor) -> torch.Tensor:
    """The JAX package's (hi * MULT mod 2^32) ^ lo hash, on int64 keys:
    hi < 2^31 keeps the product below 2^63, and the low 32 bits of a
    product are exact in any width."""
    return ((((keys >> 32) * _HASH_MULT) & MASK) ^ (keys & MASK)) \
        & ((1 << _HASH_BITS) - 1)


def _kmer_keys(codes: torch.Tensor, lens: torch.Tensor, k: int):
    hi, lo, _ = pack_kmers(codes, lens, k=k)
    return join_keys(hi, lo)


def _occ_accumulate(table, codes, lens, *, k):
    """Pass A of the occurrence prefilter: scatter-add of every valid
    window's hashed k-mer into a direct-address count table (collisions
    merge counts — one-sided: counts only ever OVER-estimate, so
    thresholding later keeps a superset)."""
    keys = _kmer_keys(codes, lens, k)
    valid = keys != KEY_SENTINEL
    h = torch.where(valid, _occ_hash(keys), 0).reshape(-1)
    return table.index_add_(0, h, valid.reshape(-1).to(torch.int32))


def _occ_mask(table, codes, lens, min_occ, *, k):
    """Pass B: KEY_SENTINEL-mask windows whose hashed occurrence count is
    below min_occ (they cannot reach the rare band's floor: a k-mer's
    read count never exceeds its occurrence count, and hash collisions
    only inflate the estimate). Returns (keys, n_keep)."""
    keys = _kmer_keys(codes, lens, k)
    # the hash is masked to the table's size, so every lookup is in range
    keep = (keys != KEY_SENTINEL) & (table[_occ_hash(keys)] >= min_occ)
    return torch.where(keep, keys, KEY_SENTINEL), keep.sum()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def read_kmer_table(
    seqs: Sequence[str],
    k: int,
    *,
    batch_rows: int = 64,
    capacity: int | None = None,
    min_occurrences: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes uint64, n_reads, n_multi) over all sequences: for each distinct
    k-mer, the number of sequences containing it and the number containing it
    more than once. Computed on `device` per batch, merged associatively.

    min_occurrences > 1 enables the OCCURRENCE PREFILTER: a first device
    pass scatter-adds hashed window counts into a direct-address table,
    and the exact pass then drops windows whose (over-)estimated count is
    below the threshold. A k-mer's read count never exceeds its
    occurrence count and collisions only inflate the estimate, so every
    k-mer that could reach min_occurrences survives — the exact tables
    then hold ~the genome-side k-mers instead of every read-error
    artifact. Dropped k-mers are exactly those with total occurrences <
    min_occurrences — callers must only use the output where that set is
    irrelevant (the rare band's floor guarantees it when min_occurrences
    <= ceil(bottom * coverage * survival))."""
    if not len(seqs):
        return (np.empty(0, np.uint64), np.empty(0, np.int64),
                np.empty(0, np.int64))
    total_windows = sum(max(0, len(s) - k + 1) for s in seqs)
    # distinct k-mers are bounded by total windows, so the
    # exact-sufficient global capacity is next_pow2(total_windows) — but
    # per-BATCH tables only need their own window count, and a
    # binary-counter merge forest keeps total merge cost
    # O(keys * log batches) instead of O(batches * global_capacity),
    # with every size a power of two
    max_capacity = capacity or (1 << max(
        8, int(np.ceil(np.log2(max(min(total_windows, 1 << 28), 2))))))

    def _pow2(x):
        return 1 << max(8, int(np.ceil(np.log2(max(int(x), 2)))))

    forest: Dict[int, tuple] = {}

    def shrink(t, n, cap):
        """Slice a sorted KEY_SENTINEL-padded table down to pow2(n): table
        capacities must track the REALIZED distinct count, not the sum of
        input capacities — without this, capacities accumulate up the
        merge chain to pow2(total windows)."""
        new_cap = max(256, _pow2(max(n, 1)))
        if new_cap >= cap:
            return t, cap
        return (t[0][:new_cap], t[1][:new_cap], t[2]), new_cap

    def merge_pair(ta, cap_a, tb, cap_b):
        nonlocal max_capacity
        out = min(_pow2(cap_a + cap_b), max_capacity)
        while True:
            m = merge_count_tables(ta[0], ta[1], tb[0], tb[1],
                                   capacity=out)
            n = int(m[2])
            if out >= cap_a + cap_b or n <= out:
                t, cap = shrink((m[0], m[1], n), n, out)
                return t, cap
            out *= 2
            if out > max_capacity:
                max_capacity = out

    def insert(t, cap):
        t, cap = shrink(t, t[2], cap)
        while cap in forest:
            other = forest.pop(cap)
            t, cap = merge_pair(other, cap, t, cap)
        forest[cap] = t

    def upload(codes, lens):
        return (torch.from_numpy(codes).to(device),
                torch.from_numpy(lens).to(device))

    # occurrence prefilter pass A: hashed window counts over the whole
    # corpus, on the device
    t_start = time.perf_counter()
    occ_table = None
    if min_occurrences > 1:
        occ_table = torch.zeros(1 << _HASH_BITS, dtype=torch.int32,
                                device=device)
        for _ids, codes, lens in _iter_batches(seqs, batch_rows, 256):
            _occ_accumulate(occ_table, *upload(codes, lens), k=k)
        _sync(device)
    t_occ = time.perf_counter()

    for ids, codes, lens in _iter_batches(seqs, batch_rows, 256):
        win_b = int(np.maximum(lens.astype(np.int64) - k + 1, 0).sum())
        codes_d, lens_d = upload(codes, lens)
        if occ_table is not None:
            keys, n_keep = _occ_mask(occ_table, codes_d, lens_d,
                                     min_occurrences, k=k)
            win_b = int(n_keep)        # survivors bound the distinct count
            if win_b == 0:
                continue
        else:
            keys = _kmer_keys(codes_d, lens_d, k)
        rid = torch.from_numpy(ids).to(device)[:, None].expand(keys.shape)
        cap_b = min(_pow2(win_b), max_capacity)
        while True:
            ukeys, n_reads, n_multi, n = count_read_kmer_stats(
                keys, rid, capacity=cap_b)
            if cap_b >= win_b or int(n) <= cap_b:
                break
            cap_b *= 2
        # tables stay ON DEVICE across the sweep — only run-count scalars
        # sync
        insert((ukeys, torch.stack([n_reads, n_multi], dim=1), int(n)),
               cap_b)

    if not forest:
        return (np.empty(0, np.uint64), np.empty(0, np.int64),
                np.empty(0, np.int64))
    t_count = time.perf_counter()
    acc, acc_cap = None, 0
    for cap in sorted(forest):
        if acc is None:
            acc, acc_cap = forest[cap], cap
        else:
            acc, acc_cap = merge_pair(acc, acc_cap, forest[cap], cap)
    codes_u64, counts = table_to_numpy(*acc)
    t_end = time.perf_counter()
    logger.info(
        "read_kmer_table phases: occ-prefilter %.3fs, count+merge %.3fs, "
        "fold+readback %.3fs (%d distinct)", t_occ - t_start,
        t_count - t_occ, t_end - t_count, len(codes_u64),
        extra={"seconds": {"rare_occ": t_occ - t_start,
                           "rare_count_merge": t_count - t_occ,
                           "rare_readback": t_end - t_count}})
    return codes_u64, counts[:, 0].astype(np.int64), \
        counts[:, 1].astype(np.int64)


def get_rare_kmers(
    seqs: Sequence[str],
    config: KmerRecruitmentConfig,
    coverage: int,
    *,
    batch_rows: int = 64,
    device="cuda",
) -> np.ndarray:
    """Sorted uint64 codes of rare k-mers (reference
    distance_based_kmer_recruitment.py:66-82 semantics, including the float
    band [bottom*coverage*survival, top*coverage*survival]).

    The band floor doubles as the occurrence-prefilter threshold: a
    k-mer with total occurrences below ceil(floor) can never reach
    n_reads >= floor, so dropping it early cannot change the rare set
    (read_kmer_table's min_occurrences contract)."""
    left = config.bottom * coverage * config.kmer_survival_rate
    right = config.top * coverage * config.kmer_survival_rate
    min_occ = int(np.ceil(left))
    codes, n_reads, n_multi = read_kmer_table(
        seqs, config.k, batch_rows=batch_rows, min_occurrences=min_occ,
        device=device)
    survive = n_multi <= config.max_nonuniq
    rare = survive & (n_reads >= left) & (n_reads <= right)
    return codes[rare]
