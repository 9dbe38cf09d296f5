"""Multi-device execution: the device mesh and the sharded pipeline steps,
the JAX package's `parallel/mesh.py` in PyTorch.

The reference's whole parallel inventory is process fan-out over read
chunks with `cat` as the reduction (reference run_read_recruitment.sh:35-44,
run_ncrf_parallel.py:39-73). Here, as in the JAX package, read batches are
data-parallel over a 1-D mesh axis ("reads"): each shard of a batch's rows
runs the single-device step on its own device, with the tables (peq, seed
bitmaps, cloud arrays) on every device. What the JAX package does with
collectives over ICI becomes explicit moves to the mesh's first device and
a reduction in the JAX package's order:
- per-shard count tables fold with `ops/kmers.merge_count_tables` in shard
  order (the JAX package's all_gather + fold, `mesh.py:130-136, 163-169,
  205-211`);
- placement's winner is the lexicographic (score0, score1) maximum over
  the shards (its pmax pair, `mesh.py:229-234`);
- recruitment needs none: each shard's rows are independent.
So every sharded result equals the single-device one bit for bit.

A `Mesh` is an ordered list of `torch.device`s: on one card it may repeat
the card (`make_mesh(4, devices=["cuda:0"] * 4)`), which is how the sharded
code is held against the single-device path with one card, as the JAX
package holds its mesh on 8 virtual CPU devices. A mesh never mixes device
types, and a mesh asked for on CUDA never holds the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from centroflye_tpu_torch.ops.kmers import merge_count_tables
from centroflye_tpu_torch.ops.myers_cuda import myers_perrow, perrow_queries

DATA_AXIS = "reads"


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An ordered list of devices along one named axis. Devices may
    repeat; shard i of a batch runs on devices[i]."""

    def __init__(self, devices: Sequence, axis: str = DATA_AXIS):
        self.devices = tuple(_device(d) for d in devices)
        self.axis = axis
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in self.devices}
        if len(kinds) > 1:
            raise ValueError(f"a mesh holds one device type, got "
                             f"{sorted(kinds)}")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def first(self) -> torch.device:
        """Where the shards' results meet."""
        return self.devices[0]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r})"


def make_mesh(n_devices: int = 0, axis: str = DATA_AXIS,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over `devices` (its first n_devices if n_devices > 0), or,
    without them, over the local CUDA devices (the first n_devices of
    them if n_devices > 0, as the JAX package's `jax.devices()[:n]`).
    Raises without CUDA when no devices are given: the CPU is used only
    when named."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; name the "
                               "devices (e.g. devices=['cpu'] * n)")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if n_devices:
            devs = devs[:n_devices]
    else:
        devs = list(devices)
        if n_devices:
            if n_devices > len(devs):
                raise ValueError(f"n_devices={n_devices} > the "
                                 f"{len(devs)} devices given")
            devs = devs[:n_devices]
    return Mesh(devs, axis)


def auto_mesh(min_devices: int = 2) -> Optional[Mesh]:
    """A mesh over every local CUDA device when there are at least
    `min_devices`, else None: the pipelines' switch between single-device
    and sharded steps. With one card it is None."""
    if torch.cuda.device_count() < min_devices:
        return None
    return make_mesh()


def resolve_mesh(mesh, device) -> Optional[Mesh]:
    """A constructor's `mesh` argument -> a `Mesh` of more than one
    device, or None: "auto" is `auto_mesh()` for a CUDA
    device and None for the CPU; a mesh must hold `device`'s type."""
    device = torch.device(device)
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh={mesh!r}: 'auto', None or a Mesh")
        mesh = auto_mesh() if device.type == "cuda" else None
    if mesh is None or mesh.size <= 1:
        return None
    if mesh.first.type != device.type:
        raise ValueError(f"a mesh of {mesh.first.type} devices for a "
                         f"{device.type} run")
    return mesh


def pad_rows(arr: np.ndarray, multiple: int, fill) -> np.ndarray:
    """Pad axis 0 to a multiple (every shard takes the same rows)."""
    r = arr.shape[0]
    target = -(-max(r, 1) // multiple) * multiple
    if target == r:
        return arr
    pad = np.full((target - r,) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], axis=0)


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


def shard_batch(mesh: Mesh, *arrays):
    """Split each array's rows (a batch's codes and lens, and any other
    row-aligned arrays) into mesh.size equal shards, shard i on
    devices[i] -> [(shard of each array) per device]. Rows must divide
    evenly (`pad_rows`)."""
    arrays = [_tensor(a) for a in arrays]
    n = mesh.size
    rows = arrays[0].shape[0]
    if rows % n or any(a.shape[0] != rows for a in arrays):
        raise ValueError(f"rows {[a.shape[0] for a in arrays]} must be "
                         f"equal and a multiple of {n} devices")
    per = rows // n
    return [tuple(a[i * per:(i + 1) * per].to(d) for a in arrays)
            for i, d in enumerate(mesh.devices)]


def replicate(mesh: Mesh, x) -> tuple:
    """x on every device of the mesh, one copy a distinct device."""
    x = _tensor(x)
    copies = {}
    return tuple(copies.setdefault(d, x.to(d)) for d in mesh.devices)


def _on(x, i: int, mesh: Mesh):
    """Device i's copy of a replicated argument: an entry of `replicate`'s
    tuple, or the tensor moved there."""
    if isinstance(x, tuple):
        return x[i]
    return _tensor(x).to(mesh.devices[i])


def _gather(mesh: Mesh, parts):
    """Per-shard tensors (or tuples of them) -> moved to the first device
    and concatenated along axis 0 in shard order."""
    if isinstance(parts[0], tuple):
        return tuple(_gather(mesh, [p[k] for p in parts])
                     for k in range(len(parts[0])))
    if len(parts) == 1:
        return parts[0].to(mesh.first)
    return torch.cat([p.to(mesh.first) for p in parts])


def _fold_tables(mesh: Mesh, tables, capacity: int):
    """(keys, counts, n) tables of the shards -> one table on the first
    device, merged in shard order as the JAX package's fold does."""
    keys, cnt, n = (t.to(mesh.first) if isinstance(t, torch.Tensor) else t
                    for t in tables[0])
    for k2, c2, _ in tables[1:]:
        keys, cnt, n = merge_count_tables(
            keys, cnt, k2.to(mesh.first), c2.to(mesh.first),
            capacity=capacity)
    return keys, cnt, n


def make_recruitment_step(mesh: Mesh, m: int):
    """Sharded recruitment distances: batch rows split over the mesh, the
    peq tables on every device; no reduction. step(peq_fwd, peq_rc,
    codes, lens) -> (dist_fwd, dist_rc) (B,) int32 on the first device,
    each shard scored by `ops/myers_cuda.recruit_distances` (K1 on a
    card)."""
    from centroflye_tpu_torch.ops.myers_cuda import recruit_distances

    def step(peq_fwd, peq_rc, codes, lens):
        pf, pr = replicate(mesh, peq_fwd), replicate(mesh, peq_rc)
        return _gather(mesh, [
            recruit_distances(pf[i], pr[i], c, ln.contiguous(), m=m)
            for i, (c, ln) in enumerate(shard_batch(mesh, codes, lens))])

    return step


def make_perrow_myers_step(mesh: Mesh, peqs, ms, *, m: int, mode: str,
                           collect: str = "call"):
    """Sharded per-row-query Myers (the monomer decomposer's step): the
    windows split over the mesh, the query set (`ops/myers_cuda.
    perrow_queries` of peqs (Q, 5, W) int64 words and ms (Q,)) laid out on
    every device once. step(windows (R, L) int8, wlens (R,) int32) -> the
    outputs of `myers_perrow` (K4 on a card, one launch a shard) on the
    first device, in window order. R must be a multiple of the mesh
    size."""
    layouts = {}                    # one layout a distinct device
    for d in mesh.devices:
        if d not in layouts:
            layouts[d] = perrow_queries(peqs, ms, m=m, device=d)
    queries = [layouts[d] for d in mesh.devices]

    def step(windows, wlens):
        outs = [myers_perrow(queries[i], w, ln, mode=mode, collect=collect)
                for i, (w, ln) in enumerate(
                    shard_batch(mesh, windows, wlens))]
        return {k: _gather(mesh, [o[k] for o in outs]) for k in outs[0]}

    return step


def make_kmer_count_step(mesh: Mesh, k: int, capacity: int):
    """Sharded exact k-mer counting: each shard's rows counted into a
    sorted `capacity` table on its device, the tables folded in shard
    order on the first device. step(codes (B, L) int8, lens (B,)) ->
    (keys, counts, n) as `ops/kmers.count_unique`."""
    from centroflye_tpu_torch.ops.kmers import (
        count_unique, join_keys, pack_kmers)

    def step(codes, lens):
        tables = []
        for c, ln in shard_batch(mesh, codes, lens):
            hi, lo, _ = pack_kmers(c, ln, k=k)
            tables.append(count_unique(join_keys(hi, lo), capacity=capacity))
        return _fold_tables(mesh, tables, capacity)

    return step


def make_stats_count_step(mesh: Mesh, k: int, capacity: int):
    """Sharded per-read k-mer statistics (the rare-k-mer stage's step):
    each shard's reads counted into (key -> (n_reads, n_multi)) tables on
    its device, folded in shard order on the first device. Reads are
    disjoint across shards, so the counters add exactly. step(codes,
    lens, rid (B, 1)) -> (keys, counts (capacity, 2), n)."""
    from centroflye_tpu_torch.ops.kmers import (
        count_read_kmer_stats, join_keys, pack_kmers)

    def step(codes, lens, rid):
        tables = []
        for c, ln, r in shard_batch(mesh, codes, lens, rid):
            hi, lo, _ = pack_kmers(c, ln, k=k)
            keys = join_keys(hi, lo)
            ukeys, n_reads, n_multi, n = count_read_kmer_stats(
                keys, r.expand(keys.shape), capacity=capacity)
            tables.append((ukeys, torch.stack([n_reads, n_multi], dim=1),
                           n))
        return _fold_tables(mesh, tables, capacity)

    return step


def make_pair_bucket_step(mesh: Mesh, *, chunk: int, capacity: int):
    """Sharded distance-pair counting (the unique-k-mer stage's step): a
    chunk's pair range [c0, c0 + chunk) splits into consecutive sub-ranges
    of chunk / mesh.size pairs, shard i enumerating the i-th from the
    sub-bucket list; the flat cloud array and the list are on every device
    (`replicate`). Per-shard (i, j, d) tables fold in shard order on the
    first device. step(flat, starts, const_vals, base_iter, a_const,
    dvals, c0, total) -> (keys, counts, n)."""
    from centroflye_tpu_torch.stages.distance_graph import (
        _pairs_from_buckets)

    n_dev = mesh.size
    if chunk % n_dev:
        raise ValueError(f"chunk {chunk} is not a multiple of {n_dev} "
                         f"devices")
    local = chunk // n_dev

    def step(flat, starts, const_vals, base_iter, a_const, dvals, c0,
             total):
        bufs = (flat, starts, const_vals, base_iter, a_const, dvals)
        tables = [_pairs_from_buckets(
            *(_on(b, i, mesh) for b in bufs), int(c0) + i * local,
            int(total), chunk=local, capacity=capacity)
            for i in range(n_dev)]
        return _fold_tables(mesh, tables, capacity)

    return step


def make_placement_score_step(mesh: Mesh):
    """Sharded placement scoring and its global winner: read bitmaps
    split over the mesh, the contig bitmap on every device. step(
    read_bitmaps (R, T, W), contig_bitmap (P, W)) -> (score0, score1)
    (R, P) int32 on the first device and best = [m0, m1], the
    lexicographic maximum: m0 the largest score0, m1 the largest score1
    among the offsets reaching m0."""
    from centroflye_tpu_torch.ops.scoring import placement_scores

    def step(read_bitmaps, contig_bitmap):
        cb = replicate(mesh, contig_bitmap)
        parts = [placement_scores(rb, cb[i]) for i, (rb,) in
                 enumerate(shard_batch(mesh, read_bitmaps))]
        m0 = max(int(s0.max()) for s0, _ in parts)
        m1 = max(int(torch.where(s0 == m0, s1, -1).max())
                 for s0, s1 in parts)
        s0, s1 = _gather(mesh, parts)
        return s0, s1, torch.tensor([m0, m1], dtype=torch.int32,
                                    device=mesh.first)

    return step
