"""The yardstick of the Myers kernels: their work, counted from the real
rows and columns of each launch, and the card's peaks.

Frozen copies of chip_smoke.py:186-190 (`OPS_PER_WORD_COLUMN`,
`INT32_LANES_PER_SM_CLOCK`, `HBM_BYTES_PER_S`), :475-496
(`int32_ops_per_s`, `myers_bound`), :671-675 (`k3_bound`'s first k + 1
query rows) and :2071-2084 (`perrow_bound`).

A bit-parallel Myers column costs 11 INT32 operations a query word (the
add with its carry 2, d0 2, hp and hn 2, the two shifts 2, vp and vn 2,
the Eq fetch 1). The card's INT32 rate is its SMs x 64 lanes x its
maximum SM clock. A roofline share is the larger of operations over that
rate and bytes over the HBM rate, divided by the device time.
"""

from __future__ import annotations

import subprocess

import numpy as np

OPS_PER_WORD_COLUMN = 11
INT32_LANES_PER_SM_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
WORD = 32


def words(rows: int) -> int:
    return -(-rows // WORD)


def int32_ops_per_s(card: int = 0) -> float:
    """The card's INT32 rate at its maximum SM clock (nvidia-smi)."""
    import torch
    smi = subprocess.run(["nvidia-smi", "-i", str(card),
                          "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    mhz = float(smi.stdout.split()[0])
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    return sms * INT32_LANES_PER_SM_CLOCK * mhz * 1e6


def threshold_work(lens, k: int, strands: int) -> tuple[float, float]:
    """(operations, bytes) of the threshold search `dist <= k` over rows
    of `lens` columns: the first k + 1 query rows (a cell of row i <= k
    has a score <= k), as words, a column, a strand; bytes: one code a
    column, the lens, each strand's peq table and two int32 outputs a
    row (chip_smoke.myers_bound)."""
    lens = np.asarray(lens, np.int64)
    n, w = int(lens.sum()), words(k + 1)
    ops = OPS_PER_WORD_COLUMN * w * n * strands
    nbytes = n + 4 * lens.size + strands * (5 * 4 * w + 8 * lens.size)
    return float(ops), float(nbytes)


def perrow_work(wlens, L: int, Q: int, w: int,
                collect: str) -> tuple[float, float]:
    """(operations, bytes) of one K4 call: every window's first
    min(wlens, L) columns against Q queries of w words, bytes read once
    (windows, lengths, peq tables, query lengths) and written once (each
    window's call, 12 bytes, or with collect="all" every row's L
    scores)."""
    wlens = np.asarray(wlens, np.int64)
    n = int(np.clip(wlens, 0, L).sum())
    R = wlens.size
    ops = OPS_PER_WORD_COLUMN * w * n * Q
    out_bytes = 12 * R if collect == "call" else 4 * R * Q * L
    nbytes = R * L + 4 * R + Q * (5 * 4 * w + 4) + out_bytes
    return float(ops), float(nbytes)


def share(ops: float, nbytes: float, rate: float, seconds: float):
    """(percent of the roofline, what sets the bound), or None without
    work or device time."""
    if not ops or not seconds:
        return None
    op_s, byte_s = ops / rate, nbytes / HBM_BYTES_PER_S
    return (100.0 * max(op_s, byte_s) / seconds,
            "operations" if op_s >= byte_s else "bytes")
