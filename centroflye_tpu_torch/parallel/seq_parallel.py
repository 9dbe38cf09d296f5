"""Sequence-parallel Myers edit distance: one read's DP columns split
across the devices of a mesh, the DP state handed from device to device,
the JAX package's `parallel/seq_parallel.py` in PyTorch.

The reference handles ultra-long reads (100 kb and more) only by banding
inside one process (edlib.cpp:538, :612-622); a read never spans workers.
Here, as in the JAX package, the target's columns split into N contiguous
chunks, chunk d on device d of a 1-D mesh. The Myers column recurrence is
sequential in the target, so chunks are pipelined over microbatches of
rows: at pipeline step t, device d runs microbatch t - d through its chunk
with kernel K5 (`ops/myers_cuda.myers_carry`; its plain version on the
CPU), then hands the whole DP state (`ops/myers.CarryState`: VP, VN, the
last row's score, best, end, final) to device d + 1 with `.to()`, the JAX
package's one `ppermute` hop (`seq_parallel.py:125-126`). After
n_micro + N - 1 steps every microbatch has passed all N chunks; only the
last stage's results count.

Exactness: the state is the complete per-row DP state between columns, so
the result equals `ops/myers.myers_distance_batch`'s bit for bit.
"""

from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from centroflye_tpu_torch.ops.myers import (
    carry_init, carry_result, words_tensor)
from centroflye_tpu_torch.ops.myers_cuda import myers_carry
from centroflye_tpu_torch.parallel.mesh import Mesh, make_mesh, replicate

SEQ_AXIS = "seq"
PAD = 4


def make_seq_mesh(n_devices: int = 0, axis: str = SEQ_AXIS,
                  devices=None) -> Mesh:
    """`parallel/mesh.make_mesh` with the sequence axis's name."""
    return make_mesh(n_devices, axis=axis, devices=devices)


def myers_distance_seqparallel(
    peq,
    text: np.ndarray,
    lens: np.ndarray,
    *,
    m: int,
    mesh: Mesh,
    axis: str = SEQ_AXIS,
    mode: Literal["HW", "SHW", "NW"] = "HW",
    n_micro: int | None = None,
):
    """`myers_distance_batch(collect="best")` with the target's columns
    split over `mesh` (its axis must be `axis`). peq: (5, W) uint32 numpy
    words or an int64 words tensor; text: (B, L) int8 codes; lens: (B,).
    Pads the columns to a device multiple and the rows to a microbatch
    multiple (PAD code 4, which never matches; padding rows have length
    0), n_micro = max(1, min(B, 2N)) by default, as the JAX package does.
    Returns {"dist": (B,) int32, "end": (B,) int32} numpy arrays."""
    if axis != mesh.axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    text = np.asarray(text)
    lens = np.asarray(lens, np.int32)
    B, L = text.shape
    N = mesh.size
    if n_micro is None:
        n_micro = max(1, min(B, 2 * N))
    Lp = -(-L // N) * N
    if Lp != L:
        text = np.pad(text, ((0, 0), (0, Lp - L)), constant_values=PAD)
    Bp = -(-B // n_micro) * n_micro
    if Bp != B:
        text = np.pad(text, ((0, Bp - B), (0, 0)), constant_values=PAD)
        lens = np.pad(lens, (0, Bp - B))
    C, b = Lp // N, Bp // n_micro
    if not isinstance(peq, torch.Tensor):
        peq = words_tensor(peq, "cpu")
    peqs = replicate(mesh, peq)
    lens_d = replicate(mesh, lens)
    # device d holds its columns [d C, (d + 1) C) of every row
    chunks = [torch.from_numpy(np.ascontiguousarray(text[:, d * C:(d + 1) * C])
                               ).to(dev) for d, dev in enumerate(mesh.devices)]
    done = []                       # (rows, result) of the last stage
    recv = {}                       # device -> the state it receives
    for t in range(n_micro + N - 1):
        sent = {}
        for d, dev in enumerate(mesh.devices):
            mb = t - d
            if not 0 <= mb < n_micro:
                continue
            rows = slice(mb * b, (mb + 1) * b)
            state = carry_init(b, m, dev) if d == 0 else recv.pop(d)
            state = myers_carry(peqs[d], chunks[d][rows], lens_d[d][rows],
                                state, d * C, m=m, mode=mode)
            if d + 1 < N:
                sent[d + 1] = state.to(mesh.devices[d + 1])
            else:
                done.append((rows, carry_result(state, lens_d[d][rows],
                                                mode)))
        recv.update(sent)
    dist = np.zeros(Bp, np.int32)
    end = np.zeros(Bp, np.int32)
    for rows, out in done:
        dist[rows] = out["dist"].cpu().numpy()
        end[rows] = out["end"].cpu().numpy()
    return {"dist": dist[:B], "end": end[:B]}
