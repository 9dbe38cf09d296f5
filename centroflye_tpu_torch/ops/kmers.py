"""Device k-mer primitives in plain PyTorch: the JAX package's
`ops/kmers.py`.

A k-mer (k <= 31) is a big-endian 2-bit code. `pack_kmers` and
`lookup_codes` carry it as a (hi, lo) pair of 32-bit words held in int64
tensors (the port's word type: torch on the CPU has no uint32 shifts),
with the SENTINEL pair on invalid windows. The counting tables carry one
int64 KEY, `hi << 32 | lo`, so one `torch.sort` orders them: valid keys
have hi < 2^31 - 1 (k-mer codes, and the distance graph's pair keys
`i << 32 | j << 8 | d`), and the SENTINEL pair becomes KEY_SENTINEL, the
largest int64, which sorts last.

Counting is sort + run boundaries + per-run sums, with static shapes:
every table is sorted, KEY_SENTINEL-padded to `capacity`, and comes with
n, the TRUE run count, which may exceed `capacity` (callers read that as
"retry larger"). Everything here is exact.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from centroflye_tpu_torch.ops.myers import MASK

SENTINEL = 0xFFFFFFFF
KEY_SENTINEL = (1 << 63) - 1


def pack_kmers(codes: torch.Tensor, lens: torch.Tensor, *, k: int):
    """All k-mer windows of a padded batch of base codes.

    Args:
      codes: (B, L) int8 base codes (0..3; >= 4 is N/PAD).
      lens: (B,) int32 sequence lengths.
      k: k-mer length, 2 <= k <= 31.

    Returns:
      (hi, lo, valid), each (B, L-k+1): hi/lo int64 32-bit words, valid
      bool marks windows inside the sequence and free of N/PAD. Invalid
      windows hold the SENTINEL pair.
    """
    B, L = codes.shape
    nwin = max(L - k + 1, 0)
    dev = codes.device
    ok = codes < 4
    vals = torch.where(ok, codes, 0).to(torch.int64) & MASK
    hi = torch.zeros((B, nwin), dtype=torch.int64, device=dev)
    lo = torch.zeros((B, nwin), dtype=torch.int64, device=dev)
    for i in range(k):
        v = vals[:, i:i + nwin]
        s = 2 * (k - 1 - i)
        if s >= 32:
            hi = hi | ((v << (s - 32)) & MASK)
        else:
            lo = lo | ((v << s) & MASK)
    # valid: all k bases ok and the window's end within len
    cs = torch.nn.functional.pad(torch.cumsum((~ok).to(torch.int32), dim=1),
                                 (1, 0))
    clean = (cs[:, k:] - cs[:, :nwin]) == 0
    pos = torch.arange(nwin, device=dev)[None, :]
    inside = pos + k <= lens.to(device=dev, dtype=torch.int64)[:, None]
    valid = clean & inside
    hi = torch.where(valid, hi, SENTINEL)
    lo = torch.where(valid, lo, SENTINEL)
    return hi, lo, valid


def lookup_codes(table_hi: torch.Tensor, table_lo: torch.Tensor,
                 hi: torch.Tensor, lo: torch.Tensor):
    """Binary-search membership of (hi, lo) codes in a sorted
    SENTINEL-padded table, branchless as in the JAX package. Returns
    (found bool, index int32) per query; index is valid only where found.

    As in the JAX package, table reads clamp to the last entry (JAX's
    gather does): a search that ends early can step past the end, and
    then a query equal to the last entry is found with index n, not n-1
    (ROADMAP Queue 3)."""
    n = table_hi.shape[0]
    lo_i = torch.zeros(hi.shape, dtype=torch.int64, device=hi.device)
    hi_i = torch.full(hi.shape, n, dtype=torch.int64, device=hi.device)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        mid = (lo_i + hi_i) // 2
        at = mid.clamp(max=n - 1)
        t_hi, t_lo = table_hi[at], table_lo[at]
        go_right = (t_hi < hi) | ((t_hi == hi) & (t_lo <= lo))
        lo_i = torch.where(go_right, mid + 1, lo_i)
        hi_i = torch.where(go_right, hi_i, mid)
    idx = torch.clamp(lo_i - 1, min=0)
    at = idx.clamp(max=n - 1)
    found = ((table_hi[at] == hi) & (table_lo[at] == lo)
             & (hi != SENTINEL))
    return found, idx.to(torch.int32)


def join_keys(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(hi, lo) 32-bit words -> int64 keys; a SENTINEL hi gives
    KEY_SENTINEL."""
    return torch.where(hi == SENTINEL, KEY_SENTINEL, (hi << 32) | lo)


def split_keys(keys: torch.Tensor):
    """int64 keys -> (hi, lo) 32-bit words; KEY_SENTINEL gives the
    SENTINEL pair."""
    sent = keys == KEY_SENTINEL
    return (torch.where(sent, SENTINEL, keys >> 32),
            torch.where(sent, SENTINEL, keys & MASK))


def sort_by_code(keys: torch.Tensor, *payloads: torch.Tensor):
    """Stable sort of flat keys; payloads ride along."""
    keys, order = torch.sort(keys, stable=True)
    return (keys,) + tuple(p[order] for p in payloads)


def _run_starts(keys: torch.Tensor) -> torch.Tensor:
    """Marks of the first element of each equal-key run of a sorted flat
    array."""
    first = torch.ones(1, dtype=torch.bool, device=keys.device)
    return torch.cat([first, keys[1:] != keys[:-1]])


def _compact_runs(keys, starts_v, weights, capacity: int):
    """Compact the runs of a sorted key array into a `capacity` table:
    run r's key goes to slot r, and each int64 weight is summed per run
    by one integer index_add_ (exact). Valid keys are a prefix
    (KEY_SENTINEL sorts last); each invalid element counts as a run of
    its own behind them, so run ids stay below max(len, capacity) and no
    slot is shared. Runs past `capacity` drop.

    Returns (ukeys, [int32 per-run sums...], n_runs)."""
    size = max(keys.numel(), capacity)
    valid = keys != KEY_SENTINEL
    rid = torch.cumsum(starts_v | ~valid, 0) - 1
    ukeys = torch.full((size,), KEY_SENTINEL, dtype=torch.int64,
                       device=keys.device).scatter_(0, rid, keys)
    sums = [torch.zeros(size, dtype=torch.int64, device=keys.device)
            .index_add_(0, rid, w)[:capacity].to(torch.int32)
            for w in weights]
    return ukeys[:capacity], sums, starts_v.sum()


def count_unique(keys: torch.Tensor, *, capacity: int):
    """Unique keys + multiplicities of a flat key array (invalid entries
    hold KEY_SENTINEL). Returns (ukeys, counts int32, n_unique): the
    table sorted ascending, KEY_SENTINEL/0-padded to `capacity`."""
    keys = torch.sort(keys.reshape(-1)).values
    valid = keys != KEY_SENTINEL
    ukeys, (counts,), n = _compact_runs(keys, _run_starts(keys) & valid,
                                        [valid.long()], capacity)
    return ukeys, counts, n


def count_read_kmer_stats(keys: torch.Tensor, read_ids: torch.Tensor, *,
                          capacity: int):
    """Per-unique-k-mer read statistics for rare-k-mer recruitment.

    For each distinct key across a flat batch of (key, read_id) pairs
    (invalid = KEY_SENTINEL), computes:
      n_reads:  number of distinct reads containing the k-mer
      n_multi:  number of distinct reads containing it more than once

    This reproduces, order-independently, the reference's sequential
    accumulation (reference distance_based_kmer_recruitment.py:44-63): a
    k-mer survives iff n_multi <= max_nonuniq, and its surviving frequency
    equals n_reads (the +=1-per-read count).

    The (key, read) order comes from two stable sorts, by read and then
    by key: exact for every k <= 31, where key and read id together need
    not fit one int64.

    Returns (ukeys, n_reads, n_multi, n_unique), the table as in
    `count_unique`."""
    rid, keys = sort_by_code(read_ids.reshape(-1).long(), keys.reshape(-1))
    keys, rid = sort_by_code(keys, rid)
    valid = keys != KEY_SENTINEL
    code_start = _run_starts(keys)
    pair_start = code_start | _run_starts(rid)
    # an element is the 2nd of its (code, read) pair iff it does not start
    # a pair and the previous element does
    prev_pair_start = torch.cat([torch.zeros(1, dtype=torch.bool,
                                             device=keys.device),
                                 pair_start[:-1]])
    second_of_pair = ~pair_start & prev_pair_start
    ukeys, (n_reads, n_multi), n = _compact_runs(
        keys, code_start & valid,
        [(pair_start & valid).long(), (second_of_pair & valid).long()],
        capacity)
    return ukeys, n_reads, n_multi, n


def merge_count_tables(keys_a, counts_a, keys_b, counts_b, *,
                       capacity: int):
    """Merge two sorted KEY_SENTINEL-padded (key -> counts) tables by
    summing the counts of equal keys. counts may be 1-D (n,) or 2-D
    (n, C) with C parallel counters. Associative and commutative.
    Returns (ukeys, summed int32, n)."""
    keys, cnt = sort_by_code(torch.cat([keys_a, keys_b]),
                             torch.cat([counts_a, counts_b]))
    valid = keys != KEY_SENTINEL
    cols = cnt[:, None] if cnt.ndim == 1 else cnt
    ukeys, sums, n = _compact_runs(
        keys, _run_starts(keys) & valid,
        [torch.where(valid, cols[:, i].long(), 0)
         for i in range(cols.shape[1])], capacity)
    summed = sums[0] if cnt.ndim == 1 else torch.stack(sums, dim=1)
    return ukeys, summed, n


# ---------------------------------------------------------------------------
# host-side helpers


def table_to_numpy(ukeys, counts, n):
    """Device table -> (codes uint64[n], counts[n]) numpy arrays."""
    n = int(n)
    return (ukeys[:n].cpu().numpy().astype(np.uint64),
            counts[:n].cpu().numpy())
