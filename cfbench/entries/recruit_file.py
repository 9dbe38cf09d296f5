"""Entry: `stages/recruitment.recruit_file`, the rr-equivalent file
driver, over a reads file made from the seed, called again and again
through the window.

Each call streams every read of the file through the native reader, the
host prescan, the fused step (K1) and the exact tier (and, with a mesh,
the sequence-parallel tier on K5), and writes the recruited reads to a
FASTA file of its own. A call's bases are every base of the file.

The check, once the window has closed: every call's output equals the
last call's byte for byte, and the last one is judged record by record
(ids known, in input order, once each, sequences those of the input) and
read by read against the plain reference: every labelled read (the
tandem copies), every read of the output, and a sample of the background
reads drawn from the seed. The reference is computed on the first card
after the program's state is freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os

import numpy as np

from cfbench.lib import roofline, spec, traffic


@dataclasses.dataclass
class State:
    reads: traffic.Reads
    reads_fn: str
    unit_fn: str
    unit: np.ndarray
    run: dict
    device: str
    mesh: object
    workdir: str
    bases: int
    outputs: list = dataclasses.field(default_factory=list)


def _recruit(st: State, reads_fn: str, out_fn: str) -> int:
    from centroflye_tpu_torch.stages.recruitment import recruit_file
    r = st.run
    return recruit_file(st.unit_fn, reads_fn, out_fn, int(r["threshold"]),
                        batch_size=int(r["batch_size"]),
                        seg_len=int(r["seg_len"]), device=st.device,
                        mesh=st.mesh)


def setup(ctx) -> State:
    run = ctx.config["run"]
    reads = traffic.generate(ctx.traffic, ctx.seed)
    reads_fn = os.path.join(ctx.workdir, "reads.fasta")
    reads.write_fasta(reads_fn)
    unit_fn = spec.path("data", run["unit"])
    unit = traffic.encode(next(iter(traffic.read_fasta(unit_fn).values())))
    st = State(reads, reads_fn, unit_fn, unit, run, ctx.device, ctx.mesh,
               ctx.workdir, int(reads.lens.sum()))
    # warm-up on the cell's own path: a file of the first reads and every
    # labelled read, through every tier the calls use
    n = min(len(reads), int(ctx.params.get("warmup_reads", 512)))
    warm = os.path.join(ctx.workdir, "warm.fasta")
    reads.write_fasta(warm, np.union1d(np.arange(n),
                                       np.nonzero(reads.labels)[0]))
    _recruit(st, warm, os.path.join(ctx.workdir, "warm.out.fasta"))
    return st


def call(st: State, i: int) -> int:
    out = os.path.join(st.workdir, f"out{i:04d}.fasta")
    _recruit(st, st.reads_fn, out)
    st.outputs.append(out)
    return st.bases


def parse_fasta(fn: str) -> list:
    out = []
    with open(fn) as f:
        data = f.read().split("\n")
    for k in range(0, len(data) - 1, 2):
        out.append((data[k][1:] if data[k].startswith(">") else None,
                    data[k + 1]))
    return out


def _sample(ctx, st: State, out_idx: np.ndarray) -> np.ndarray:
    """The reads the reference decides: every labelled read, every read
    of the output, and a seed-drawn sample of the background reads."""
    rng = np.random.default_rng([int(ctx.seed), 0x636B])
    lab = np.nonzero(st.reads.labels != 0)[0]
    bg = np.nonzero(st.reads.labels == 0)[0]
    n_bg = min(int(ctx.params.get("check_background", 256)), bg.size)
    return np.unique(np.concatenate([
        lab, rng.choice(bg, n_bg, replace=False),
        np.asarray(out_idx, np.int64)]))


def judge(ctx, st: State, records: list, decide) -> dict:
    """The numbers compared for one output (list of (id, sequence)):
    decide(indices) gives the reference's decision for those reads."""
    index = {r: k for k, r in enumerate(st.reads.ids)}
    bad_records, last, out_idx = 0, -1, []
    for r_id, seq in records:
        k = index.get(r_id)
        if k is None or k <= last or seq != st.reads.text(k):
            bad_records += 1
        if k is not None:
            last = max(last, k)
            out_idx.append(k)
    S = _sample(ctx, st, np.array(out_idx, np.int64))
    want = decide(S)
    got = np.isin(S, np.array(out_idx, np.int64))
    return {"records_wrong": bad_records,
            "decisions_wrong": int((want != got).sum())}


def _decider(ctx, st: State, ref, strands):
    thr = int(st.run["threshold"])

    def decide(S):
        return ref.recruited(st.unit, [st.reads.seq(k) for k in S], thr,
                             ctx.ref_device, strands=strands)
    return decide


def _digest(fn: str) -> str:
    h = hashlib.sha256()
    with open(fn, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def check(ctx, st: State, ref) -> tuple[dict, int]:
    """-> ({name: (value, limit)}, failed calls)."""
    digests = [_digest(fn) for fn in st.outputs]
    last = st.outputs[-1]
    got = judge(ctx, st, parse_fasta(last), _decider(ctx, st, ref,
                                                    ("fwd", "rc")))
    differ = sum(d != digests[-1] for d in digests)
    for fn in st.outputs:
        os.unlink(fn)
    wrong = got["records_wrong"] + got["decisions_wrong"]
    failed = differ + (len(digests) - differ if wrong else 0)
    return ({"records_wrong": (got["records_wrong"], 0),
             "decisions_wrong": (got["decisions_wrong"], 0),
             "calls_differing": (differ, 0)}, failed)


def control(ctx, st: State, ref) -> dict:
    """The control in the program's place: the reference on the forward
    strand alone (it breaks the guarantee that either strand recruits).
    Its output holds the sampled reads it recruits, judged as the
    program's output is."""
    S = _sample(ctx, st, np.zeros(0, np.int64))
    ctl = _decider(ctx, st, ref, ("fwd",))(S)
    records = [(st.reads.ids[k], st.reads.text(k)) for k in S[ctl]]
    got = judge(ctx, st, records, _decider(ctx, st, ref, ("fwd", "rc")))
    return {"records_wrong": (got["records_wrong"], 0),
            "decisions_wrong": (got["decisions_wrong"], 0)}


@contextlib.contextmanager
def probes(ctx, st: State, probe):
    """The traced run's wrappers: spans around the reader's iterator, the
    host prescan and the writer's decode, and the threshold search's work
    of every device launch that answers it (the fused step's survivors,
    the exact tier's rows, the sequence-parallel tier's reads)."""
    import centroflye_tpu_torch.native as native
    import centroflye_tpu_torch.ops.fused_recruit as fr
    import centroflye_tpu_torch.ops.seed_filter as sf
    import centroflye_tpu_torch.parallel.seq_parallel as sp
    import centroflye_tpu_torch.stages.recruitment as rec

    k = int(st.run["threshold"])

    def count(lens, strands):
        ops, nbytes = roofline.threshold_work(lens, k, strands)
        probe.counters["threshold_ops"] += ops
        probe.counters["threshold_bytes"] += nbytes

    orig_make = fr.make_fused_recruit

    def make(*a, **kw):
        fused = orig_make(*a, **kw)
        budget = int(kw.get("k_budget", 128))
        raw, unbundle, fifo = fused.raw, fused.unbundle, []

        def raw_counted(packed, n_mask, lens):
            fifo.append(np.array(lens, np.int64))
            return raw(packed, n_mask, lens)

        def unbundle_counted(out, B):
            res = unbundle(out, B)
            lens = fifo.pop(0)
            hits, n_pass = res[2], res[3]
            if n_pass <= budget:          # else the exact tier scores them
                count(lens[hits >= fused.min_hits], 2)
            return res

        fused.raw, fused.unbundle = raw_counted, unbundle_counted
        return fused

    orig_dist = rec.RecruitmentEngine.distances

    def distances(self, codes, lens):
        count(lens, 2)
        return orig_dist(self, codes, lens)

    orig_sp = sp.myers_distance_seqparallel

    def seqpar(peq, text, lens, *a, **kw):
        count(lens, 1)
        return orig_sp(peq, text, lens, *a, **kw)

    saved = [(native, "native_iter_seqs"), (sf, "host_prescan_hits"),
             (rec, "decode"), (fr, "make_fused_recruit"),
             (rec.RecruitmentEngine, "distances"),
             (sp, "myers_distance_seqparallel")]
    old = [getattr(o, n) for o, n in saved]
    native.native_iter_seqs = probe.wrap_iter(native.native_iter_seqs,
                                              "recruit.reader")
    sf.host_prescan_hits = probe.wrap(sf.host_prescan_hits,
                                      "recruit.prescan")
    rec.decode = probe.wrap(rec.decode, "recruit.writer")
    fr.make_fused_recruit = make
    rec.RecruitmentEngine.distances = distances
    sp.myers_distance_seqparallel = seqpar
    try:
        yield
    finally:
        for (o, n), v in zip(saved, old):
            setattr(o, n, v)
