"""Read recruitment: select reads containing the HOR unit.

Counterpart of the JAX package's `stages/recruitment.py`, itself the
equivalent of the reference's native recruiter (rr.cpp:41-90: per read,
HW-mode edit distance of the unit and of its reverse complement; keep the
read if either strand aligns within the threshold).

Reads are cut into fixed-length segments that overlap by
``len(unit) + threshold - 1``, so any unit alignment within the threshold
lies inside some segment; a read's distance is the minimum over its
segments. Segments from many reads pack into dense (B, SEG) batches.

`run()` has three tiers under `config.prefilter`:
1. a host prescan (numpy, ops/seed_filter.host_prescan_hits) resolves
   rows with no sampled seed hit before anything is uploaded. Its rows
   are filled by the native library (`native/seqio.cpp`): each segment
   is encoded and 2-bit packed in one scan straight into the prescan
   batch (`cf_encode_pack_row` from a string, `cf_pack2bit` from int8
   codes), and a row with a non-ACGT base goes to the exact tier as it
   is filled. With `native_fill=False` numpy encodes and packs instead,
   and such rows go to the exact tier when the batch is prescanned. So
   it does with `seg_len % 8 != 0`, where `pack_2bit` then asserts at
   the first prescan, as in the JAX package;
2. the fused device step (ops/fused_recruit) filters the candidate rows
   and scores the survivors with the two-strand Myers kernel;
3. the exact tier, `distances()`, scores candidate overflow and rows with
   in-range N bases (and every row with the prefilter off).

With a mesh (`parallel/mesh.Mesh` of more than one device), the fused
step's rows shard over it, and reads of at least
`config.seq_parallel_min_len` take the sequence-parallel tier instead:
the whole read's DP columns split over the mesh (parallel/seq_parallel,
kernel K5), no segments, and no host prescan. The whole-read HW minimum
equals the overlapped-segment minimum, so with the prefilter off the
distances are the single-device ones. With it on, a long read that the
prescan would resolve as (m, m) on one device gets its exact distance
here instead, as in the JAX package. The recruited sets then agree
wherever the prescan drops only reads outside the threshold, as the
prefiltered set equal to the exact tier's shows.
`recruit_file(..., distributed=True)` shards the read stream over the
processes of a gloo group (parallel/distributed) and merges their
partial files on process 0.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch

from centroflye_tpu_torch.config import RecruitmentConfig
from centroflye_tpu_torch.io.encoding import PAD, decode, encode, revcomp
from centroflye_tpu_torch.ops.myers import build_peq, words_tensor
from centroflye_tpu_torch.ops.myers_cuda import recruit_distances
from centroflye_tpu_torch.parallel.mesh import resolve_mesh


@dataclasses.dataclass
class RecruitmentResult:
    r_id: str
    dist_fwd: int
    dist_rc: int
    recruited: bool


def segment_starts(read_len: int, seg_len: int, overlap: int) -> List[int]:
    """Start offsets of segments covering [0, read_len) with `overlap`
    shared bases between consecutive segments."""
    if read_len <= seg_len:
        return [0]
    stride = seg_len - overlap
    return list(range(0, read_len - overlap, stride))


class RecruitmentEngine:
    """Streaming recruiter: feed reads, collect per-read decisions."""

    def __init__(self, unit: str, config: RecruitmentConfig | None = None,
                 seg_len: int = 32768, device="cuda", *,
                 state: dict | None = None, mesh="auto",
                 native_fill: bool = True):
        """device: where the tables live and the device tiers run.
        state: tables from `convert.recruitment_state_from_numpy`, used in
        place of the tables built from `unit` (see `from_state`).
        mesh: "auto" shards over every local card when there are more
        than one (`parallel/mesh.auto_mesh`; on a CPU device, none); None
        runs on `device` alone; a `Mesh` pins the devices, its type
        `device`'s. A mesh of one device is none. The exact tier runs on
        the mesh's first device. native_fill=False fills the prescan
        batch with numpy instead of the native library; the per-read
        results are the same."""
        self.config = config or RecruitmentConfig()
        self.native_fill = native_fill
        self.unit = unit
        self.m = len(unit)
        self.device = torch.device(device)
        self.mesh = resolve_mesh(mesh, self.device)
        if self.mesh is not None:
            self.device = self.mesh.first
        n_dev = self.mesh.size if self.mesh is not None else 1
        if state is None:
            state = self._build_state(unit, self.config, self.device)
        self.peq_fwd = state["peq_fwd"].to(self.device)
        self.peq_rc = state["peq_rc"].to(self.device)
        self.threshold = self.config.threshold
        self.overlap = self.m + self.threshold - 1
        self.seg_len = max(seg_len, self.overlap + self.m)
        # fused batches shard row-wise over the mesh: keep rows divisible
        self.batch = -(-self.config.batch_size // n_dev) * n_dev
        # the sequence-parallel long-read tier, active only with a mesh
        self.seqpar_min = (self.config.seq_parallel_min_len
                           if self.mesh is not None else 0)
        # in-flight fused-bundle queue depth
        self.queue_depth = 2
        if self.config.prefilter:
            from centroflye_tpu_torch.ops.fused_recruit import (
                make_fused_recruit)
            self.k_budget = 128
            self._seed_hi = state["seed_hi"].to(self.device)
            self._seed_lo = state["seed_lo"].to(self.device)
            self._seed_bitmap = state["bitmap"].to(self.device)
            self._bitmap_le = state["bitmap_le"].to(self.device)
            self._bitmap_le_host = state["bitmap_le"].cpu().numpy().astype(
                np.uint32)                  # for the host prescan
            # candidate (device) batch: small, since the host prescan
            # drops most rows before upload
            self.cand_batch = min(self.batch, -(-256 // n_dev) * n_dev)
            self._fused = make_fused_recruit(
                self._seed_bitmap, self.peq_fwd, self.peq_rc,
                m=self.m, seed_k=self.config.seed_k,
                min_hits=self.config.min_seed_hits, k_budget=self.k_budget,
                seed_bitmap_le=self._bitmap_le, mesh=self.mesh)

    @staticmethod
    def _build_state(unit: str, config: RecruitmentConfig, device) -> dict:
        unit_codes = encode(unit)
        state = {"peq_fwd": words_tensor(build_peq(unit_codes), device),
                 "peq_rc": words_tensor(build_peq(revcomp(unit_codes)),
                                        device)}
        if config.prefilter:
            from centroflye_tpu_torch.ops.seed_filter import (
                build_seed_bitmap, build_seed_table)
            k = config.seed_k
            seed_hi, seed_lo = build_seed_table(unit, k=k)
            state["seed_hi"] = words_tensor(seed_hi, device)
            state["seed_lo"] = words_tensor(seed_lo, device)
            state["bitmap"] = words_tensor(build_seed_bitmap(unit, k=k),
                                           device)
            state["bitmap_le"] = words_tensor(
                build_seed_bitmap(unit, k=k, le=True), device)
        return state

    @classmethod
    def from_state(cls, unit: str, config: RecruitmentConfig | None,
                   state: dict, seg_len: int = 32768, device="cuda"):
        """Engine over carried tables (convert.recruitment_state_from_numpy)
        instead of tables built from `unit`."""
        return cls(unit, config, seg_len=seg_len, device=device, state=state)

    def seed_counts(self, codes: np.ndarray, lens: np.ndarray):
        """(B, SEG) int8 batch -> (B,) int32 numpy seed hit counts (both
        strands) by binary search in the seed table, on the engine's
        device. Needs the prefilter's tables."""
        from centroflye_tpu_torch.ops.seed_filter import seed_hit_counts
        counts = seed_hit_counts(
            self._seed_hi, self._seed_lo,
            torch.from_numpy(np.asarray(codes)).to(self.device),
            torch.from_numpy(np.asarray(lens)).to(self.device),
            k=self.config.seed_k)
        return counts.cpu().numpy()

    def distances(self, codes: np.ndarray, lens: np.ndarray):
        """(B, SEG) int8 batch -> (dist_fwd, dist_rc) each (B,) int32
        tensors on the engine's device, not waited for."""
        codes = torch.from_numpy(codes).to(self.device)
        lens = torch.from_numpy(lens).to(self.device)
        return recruit_distances(self.peq_fwd, self.peq_rc, codes, lens,
                                 m=self.m)

    # -- streaming host loop ---------------------------------------------

    def run(self, reads: Iterable[Tuple[str, str]],
            ) -> Iterator[RecruitmentResult]:
        """Stream (r_id, seq) pairs; yields per-read results in input
        order. seq is a string or an int8 code array. Failing segments
        resolve as non-matching (dist = m)."""
        SEG = self.seg_len
        prefilter = self.config.prefilter
        B_f = self.batch                  # host prescan batch: never uploaded
        B = 128 if prefilter else self.batch
        B_c = self.cand_batch if prefilter else 0

        seg_codes = np.full((B, SEG), PAD, dtype=np.int8)
        seg_lens = np.zeros((B,), dtype=np.int32)
        seg_read: List[int] = []          # myers-batch row -> read index

        # prescan batch: rows are overwritten on enqueue and rows beyond
        # the fill level carry len 0, so the buffer recycles uncleared;
        # the prescan is synchronous, so one buffer suffices. The native
        # fill packs each segment row in place (f_packed); the numpy fill
        # keeps int8 codes (f_codes) and packs them at the flush
        native_fill = prefilter and self.native_fill and SEG % 8 == 0
        SEGQ = SEG // 4
        f_lens = np.zeros((B_f,), dtype=np.int32)
        f_read: List[int] = []            # prescan-batch row -> read index
        f_codes = (np.full((B_f, SEG), PAD, dtype=np.int8)
                   if prefilter and not native_fill else None)
        if native_fill:
            from centroflye_tpu_torch.native import (get_encode_pack,
                                                     get_pack2bit_row)
            enc_pack = get_encode_pack()
            pack_row = get_pack2bit_row()
            f_packed = np.zeros((B_f, SEGQ), dtype=np.uint8)
            f_base = f_packed.ctypes.data
            # one-row scratch for int8 code input (the native reader's)
            t_codes = np.empty((SEG,), np.int8)
            t_len = np.empty((1,), np.int32)
            t_mask = np.empty((SEG // 8,), np.uint8)
            t_codes_ptr = t_codes.ctypes.data
            t_len_ptr = t_len.ctypes.data
            t_mask_ptr = t_mask.ctypes.data

        # candidate batch buffers: recycled only after their in-flight
        # bundle drains, since an asynchronous upload may still read them
        cand_bufs: List[Tuple[np.ndarray, np.ndarray]] = [
            (np.zeros((max(B_c, 1), SEG // 4), dtype=np.uint8),
             np.zeros((max(B_c, 1),), dtype=np.int32)) for _ in range(4)]
        c_packed, c_lens = cand_bufs.pop()
        c_read: List[int] = []            # candidate row -> read index

        # per pending read: [r_id, n_pending_segments, min_f, min_r]
        pending: dict = {}
        order: List[int] = []             # read indices in input order
        done: dict = {}
        next_emit = 0
        inflight: List[Tuple] = []
        # fused-tier queue: (device bundle, row->read map, packed, lens);
        # bundles stay on the device until drained so later batches'
        # uploads and compute overlap earlier readbacks
        f_inflight: List[Tuple] = []
        F_DEPTH = self.queue_depth

        def resolve(ridx, df, dr):
            rec = pending[ridx]
            rec[2] = min(rec[2], df)
            rec[3] = min(rec[3], dr)
            rec[1] -= 1
            if rec[1] == 0:
                done[ridx] = rec
                del pending[ridx]

        def enqueue_myers(codes_row, length, ridx):
            row = len(seg_read)
            seg_codes[row, :length] = codes_row[:length]
            seg_codes[row, length:] = PAD
            seg_lens[row] = length
            seg_read.append(ridx)
            if len(seg_read) == B:
                flush_myers()

        def flush_myers():
            nonlocal seg_codes, seg_lens, seg_read
            if not seg_read:
                return
            rows = len(seg_read)
            df, dr = self.distances(seg_codes, seg_lens)
            inflight.append((df, dr, list(seg_read), rows))
            seg_codes = np.full((B, SEG), PAD, dtype=np.int8)
            seg_lens = np.zeros((B,), dtype=np.int32)
            seg_read = []
            while len(inflight) > 2:
                drain_one()

        def flush_prescan():
            """Host tier: pack the batch, prescan it, and route every row:
            misses resolve now, rows with in-range N go to the exact tier,
            candidates are copied (packed) into the device batch."""
            nonlocal f_read
            if not f_read:
                return
            from centroflye_tpu_torch.ops.seed_filter import (
                host_prescan_hits)
            rows = len(f_read)
            if native_fill:
                # packed in place at the fill; N rows never entered
                packed, n_rows = f_packed[:rows], None
            else:
                from centroflye_tpu_torch.ops.fused_recruit import (
                    pack_2bit)
                f_lens[rows:] = 0        # stale recycled rows: ignore
                packed, n_mask = pack_2bit(f_codes, f_lens)
                packed = packed[:rows]
                n_rows = (n_mask.any(axis=1) if n_mask is not None
                          else None)
            hits_a = host_prescan_hits(packed, f_lens[:rows],
                                       self._bitmap_le_host,
                                       k=self.config.seed_k)
            for row, ridx in enumerate(f_read):
                if n_rows is not None and n_rows[row]:
                    enqueue_myers(f_codes[row], int(f_lens[row]), ridx)
                elif not hits_a[row]:
                    resolve(ridx, self.m, self.m)
                else:
                    crow = len(c_read)
                    c_packed[crow] = packed[row]
                    c_lens[crow] = f_lens[row]
                    c_read.append(ridx)
                    if len(c_read) == B_c:
                        flush_cands()
            f_read = []

        def flush_cands():
            """Fused device tier: one call filters the candidate rows and
            scores the survivors. The bundle stays on the device in
            f_inflight until drained."""
            nonlocal c_packed, c_lens, c_read
            if not c_read:
                return
            rows = len(c_read)
            c_lens[rows:] = 0            # stale recycled rows: ignore
            bundle = self._fused.raw(c_packed, None, c_lens)
            f_inflight.append((bundle, c_read, c_packed, c_lens))
            if cand_bufs:
                c_packed, c_lens = cand_bufs.pop()
            else:
                c_packed = np.zeros((B_c, SEG // 4), dtype=np.uint8)
                c_lens = np.zeros((B_c,), dtype=np.int32)
            c_read = []
            while len(f_inflight) > F_DEPTH:
                drain_cands_one()

        def drain_cands_one():
            """Read back the oldest fused bundle; overflow beyond the
            survivor budget goes to the exact tier (candidate rows hold no
            N, so the host unpack is exact)."""
            bundle, rows_map, packed_snap, lens_snap = f_inflight.pop(0)
            df, dr, hits, n_pass = self._fused.unbundle(
                bundle.cpu().numpy(), lens_snap.shape[0])
            if n_pass <= self.k_budget:
                for row, ridx in enumerate(rows_map):
                    resolve(ridx, int(df[row]), int(dr[row]))
            else:
                from centroflye_tpu_torch.ops.fused_recruit import (
                    unpack_2bit_host)
                codes_snap = unpack_2bit_host(packed_snap)
                for row, ridx in enumerate(rows_map):
                    # the fused filter's threshold, scaled to its stride
                    if int(hits[row]) >= self._fused.min_hits:
                        enqueue_myers(codes_snap[row], int(lens_snap[row]),
                                      ridx)
                    else:
                        resolve(ridx, self.m, self.m)
            cand_bufs.append((packed_snap, lens_snap))

        def drain_one():
            df, dr, rows_map, rows = inflight.pop(0)
            df = df.cpu().numpy()[:rows]
            dr = dr.cpu().numpy()[:rows]
            for row, ridx in enumerate(rows_map):
                resolve(ridx, int(df[row]), int(dr[row]))

        def emit_ready():
            nonlocal next_emit
            while next_emit < len(order) and order[next_emit] in done:
                ridx = order[next_emit]
                r_id, _, mf, mr = done.pop(ridx)
                yield RecruitmentResult(
                    r_id=r_id, dist_fwd=mf, dist_rc=mr,
                    recruited=min(mf, mr) <= self.threshold)
                next_emit += 1

        # in-order emission lag bound: one straggler parked in a part-
        # filled exact-tier batch blocks ordered emission of every later
        # read, and streaming callers hold those reads' sequences until it
        # resolves; past the bound, force-flush every tier
        LAG_LIMIT = max(32768, 16 * B)

        # the sequence-parallel tier: whole reads, a batch of LB, scored
        # with their DP columns split over the mesh (exact: the whole-read
        # HW minimum equals the overlapped-segment minimum)
        long_batch: List[Tuple[int, np.ndarray]] = []
        LB = 8

        def flush_seqpar():
            nonlocal long_batch
            if not long_batch:
                return
            from centroflye_tpu_torch.parallel.seq_parallel import (
                myers_distance_seqparallel)
            Lmax = max(len(c) for _, c in long_batch)
            Lb = -(-Lmax // SEG) * SEG      # columns bucketed to seg_len
            text = np.full((len(long_batch), Lb), PAD, np.int8)
            lens_l = np.zeros((len(long_batch),), np.int32)
            for i, (_, c) in enumerate(long_batch):
                text[i, :len(c)] = c
                lens_l[i] = len(c)
            out_f, out_r = (myers_distance_seqparallel(
                peq, text, lens_l, m=self.m, mesh=self.mesh,
                axis=self.mesh.axis) for peq in (self.peq_fwd, self.peq_rc))
            for i, (ridx, _) in enumerate(long_batch):
                resolve(ridx, int(out_f["dist"][i]), int(out_r["dist"][i]))
            long_batch = []

        def force_drain():
            if prefilter:
                flush_prescan()
                flush_cands()
                while f_inflight:
                    drain_cands_one()
            flush_myers()
            while inflight:
                drain_one()
            flush_seqpar()

        read_idx = 0
        for r_id, seq in reads:
            if read_idx - next_emit > LAG_LIMIT:
                force_drain()
                yield from emit_ready()
            if native_fill and not isinstance(seq, np.ndarray):
                raw = seq.encode("ascii")    # rows pack from the ASCII
                codes = None
                n_len = len(raw)
            else:
                codes = seq if isinstance(seq, np.ndarray) else encode(seq)
                n_len = len(codes)
            if self.seqpar_min and n_len >= self.seqpar_min:
                pending[read_idx] = [r_id, 1, self.m, self.m]
                order.append(read_idx)
                c = codes if codes is not None else encode(seq)
                long_batch.append((read_idx, np.asarray(c, np.int8)))
                if len(long_batch) >= LB:
                    flush_seqpar()
                    yield from emit_ready()
                read_idx += 1
                continue
            starts = segment_starts(n_len, SEG, self.overlap)
            pending[read_idx] = [r_id, len(starts), self.m, self.m]
            order.append(read_idx)
            for st in starts:
                ln = min(SEG, n_len - st)
                if native_fill:
                    row = len(f_read)
                    if codes is None:
                        flag = enc_pack(raw, st, ln, f_base + row * SEGQ,
                                        SEGQ)
                    else:
                        t_codes[:ln] = codes[st:st + ln]
                        t_len[0] = ln
                        flag = pack_row(t_codes_ptr, 1, SEG, t_len_ptr,
                                        f_base + row * SEGQ, t_mask_ptr)
                    if flag:
                        # a non-ACGT base in range: the exact tier
                        enqueue_myers(encode(seq[st:st + ln])
                                      if codes is None
                                      else codes[st:st + ln], ln, read_idx)
                    else:
                        f_lens[row] = ln
                        f_read.append(read_idx)
                        if len(f_read) == B_f:
                            flush_prescan()
                            yield from emit_ready()
                elif prefilter:
                    row = len(f_read)
                    f_codes[row, :ln] = codes[st:st + SEG]
                    f_codes[row, ln:] = PAD
                    f_lens[row] = ln
                    f_read.append(read_idx)
                    if len(f_read) == B_f:
                        flush_prescan()
                        yield from emit_ready()
                else:
                    enqueue_myers(codes[st:st + SEG], ln, read_idx)
                    yield from emit_ready()
            read_idx += 1
        flush_seqpar()
        if prefilter:
            flush_prescan()
            flush_cands()
            while f_inflight:
                drain_cands_one()      # may enqueue exact-tier rows
        flush_myers()
        while inflight:
            drain_one()
        yield from emit_ready()


def recruit_file(unit_fn: str, reads_fn: str, output_fn: str,
                 threshold: int, batch_size: int = 256,
                 seg_len: int = 32768, device="cuda", mesh="auto",
                 distributed: bool = False) -> int:
    """File-level entry point with the CLI contract of the reference rr binary
    (rr.cpp:43: unit.fasta reads.fasta[.gz] output.fasta threshold).
    The reads stream through the native reader (`native_iter_seqs`) as
    int8 base codes into the engine; recruited reads stream to
    `output_fn` in input order as their codes decoded, so upper case with
    every letter but ACGT written as N, as in the JAX package. Returns
    their number. mesh: as `RecruitmentEngine`'s.

    distributed=True in a multi-process run (`parallel/distributed.
    init_distributed`) shards the read stream round robin over the
    processes (the reference's awk split + xargs -P fan-out,
    run_read_recruitment.sh:35-44): each recruits its share on its own
    devices and writes a partial file, and process 0 merges them in
    global input order into the single-process file. Single-process runs
    are unchanged."""
    from centroflye_tpu_torch.parallel.distributed import process_count

    if distributed and process_count() > 1:
        return _recruit_file_distributed(
            unit_fn, reads_fn, output_fn, threshold=threshold,
            batch_size=batch_size, seg_len=seg_len, device=device,
            mesh=mesh)
    from centroflye_tpu_torch.io.fasta import atomic_write, read_seq
    from centroflye_tpu_torch.native import native_iter_seqs

    unit = read_seq(unit_fn)
    engine = RecruitmentEngine(
        unit, RecruitmentConfig(threshold=threshold, batch_size=batch_size),
        seg_len=seg_len, device=device, mesh=mesh)

    # sequences are held only while their decision is pending, keyed by
    # input position, not id: duplicate ids stream through like rr's
    pending_seqs: collections.deque = collections.deque()

    def reads_iter():
        for r_id, codes in native_iter_seqs(reads_fn):
            pending_seqs.append(codes)
            yield r_id, codes

    n_recruited = 0
    with atomic_write(output_fn) as out:
        for res in engine.run(reads_iter()):
            codes = pending_seqs.popleft()
            if res.recruited:
                out.write(f">{res.r_id}\n{decode(codes)}\n")
                n_recruited += 1
    return n_recruited


def _recruit_file_distributed(unit_fn: str, reads_fn: str, output_fn: str,
                              *, threshold: int, batch_size: int,
                              seg_len: int, device, mesh) -> int:
    """`recruit_file`'s multi-process body: every process streams the
    shared input, keeps its round-robin share, recruits it and writes
    `output_fn.part{p}` with global ordinals in the headers; process 0
    merges. Returns the global recruited count on process 0, the local
    count elsewhere."""
    import os

    from centroflye_tpu_torch.io.fasta import read_seq
    from centroflye_tpu_torch.native import native_iter_seqs
    from centroflye_tpu_torch.parallel.distributed import (
        finish_partial, is_coordinator, merge_partial_fastas, partial_path,
        shard_read_stream)

    unit = read_seq(unit_fn)
    engine = RecruitmentEngine(
        unit, RecruitmentConfig(threshold=threshold, batch_size=batch_size),
        seg_len=seg_len, device=device, mesh=mesh)
    pending: collections.deque = collections.deque()   # (ordinal, codes)

    def reads_iter():
        for ordinal, (r_id, codes) in shard_read_stream(
                native_iter_seqs(reads_fn)):
            pending.append((ordinal, codes))
            yield r_id, codes

    os.makedirs(os.path.dirname(os.path.abspath(output_fn)), exist_ok=True)
    n_local = 0
    with open(partial_path(output_fn), "w") as out:
        for res in engine.run(reads_iter()):
            ordinal, codes = pending.popleft()
            if res.recruited:
                out.write(f">{ordinal} {res.r_id}\n{decode(codes)}\n")
                n_local += 1
    finish_partial(output_fn)
    if is_coordinator():
        return merge_partial_fastas(output_fn)
    return n_local


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(
        description="Recruit centromeric reads (rr equivalent)")
    parser.add_argument("unit")
    parser.add_argument("reads")
    parser.add_argument("output")
    parser.add_argument("threshold", type=int)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    n = recruit_file(args.unit, args.reads, args.output, args.threshold,
                     batch_size=args.batch_size, device=args.device)
    print(f"recruited {n} reads")


if __name__ == "__main__":
    main()
