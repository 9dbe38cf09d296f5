"""Entry: `mono/string_decomposer.MonomerDecomposer.decompose`, the cen6
monomer decomposition, built once in set-up and called through the
window on full lockstep batches.

The traffic's reads are a pool; call i takes the next `reads_per_call`
reads of it, cyclically, each copy under an id of its own, so every call
is a full batch as in a run at the configuration's scale. A call's bases
are the bases of its reads.

The check, once the window has closed: every call returned records for
each of its reads, and, for a sample of pool reads drawn from the seed
with the pool's longest read in it, every call's records of that read
(symbol, strand, start, end, reliability) equal the plain reference's,
computed on the first card after the program's state is freed.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from cfbench.lib import roofline, traffic


@dataclasses.dataclass
class State:
    pool: list                # (id, sequence) of the traffic's reads
    lens: np.ndarray
    monomers: dict
    run: dict
    per_call: int
    dec: object
    sample: np.ndarray        # pool indices the reference checks
    kept: list = dataclasses.field(default_factory=list)  # (call, j, recs)
    missing: list = dataclasses.field(default_factory=list)


def _batch(st: State, i: int) -> list:
    n = len(st.pool)
    idx = (i * st.per_call + np.arange(st.per_call)) % n
    first = i * st.per_call
    return [(f"k{first + k:09d}_{st.pool[j][0]}", st.pool[j][1])
            for k, j in enumerate(idx)], idx


def setup(ctx) -> State:
    from centroflye_tpu_torch.mono.string_decomposer import (
        MonomerDecomposer, MonomerDecomposerConfig)
    run = ctx.config["run"]
    reads = traffic.generate(ctx.traffic, ctx.seed)
    pool = [(reads.ids[k], reads.text(k)) for k in range(len(reads))]
    monomers = traffic.data_fasta(run["monomers"])
    per_call = int(run["batch_reads"])
    dec = MonomerDecomposer(
        monomers, MonomerDecomposerConfig(
            max_divergence=float(run["max_divergence"]),
            batch_reads=per_call, slack=int(run["slack"])),
        device=ctx.device, mesh=ctx.mesh)
    rng = np.random.default_rng([int(ctx.seed), 0x636B])
    lens = reads.lens
    n_s = min(len(pool), int(ctx.params.get("check_reads", 192)))
    sample = np.unique(np.concatenate([
        rng.choice(len(pool), n_s, replace=False), [int(np.argmax(lens))]]))
    st = State(pool, lens, monomers, run, per_call, dec, sample)
    # warm-up on the cell's own path: a full batch (the first full batch
    # of a process runs about a second slower than the next)
    dec.decompose(_batch(st, -1)[0])
    return st


def call(st: State, i: int) -> int:
    batch, idx = _batch(st, i)
    out = st.dec.decompose(batch)
    st.missing.append(sum(r_id not in out for r_id, _ in batch))
    where = np.nonzero(np.isin(idx, st.sample))[0]
    for k in where:
        st.kept.append((i, int(idx[k]), out.get(batch[k][0])))
    return int(st.lens[idx].sum())


def release(st: State):
    st.dec = None


def _reference(ctx, st: State, ref, strands):
    reads = [st.pool[j] for j in st.sample]
    return ref.decompose(st.monomers, reads, st.run, ctx.ref_device,
                         strands=strands)


def _compare(st: State, want: dict, kept: list):
    wrong, bad_calls = 0, set()
    for i, j, recs in kept:
        if recs != want[st.pool[j][0]]:
            wrong += 1
            bad_calls.add(i)
    return wrong, bad_calls


def check(ctx, st: State, ref) -> tuple[dict, int]:
    want = _reference(ctx, st, ref, ("fwd", "rc"))
    wrong, bad_calls = _compare(st, want, st.kept)
    bad_calls |= {i for i, n in enumerate(st.missing) if n}
    return ({"reads_wrong": (wrong, 0),
             "reads_missing": (int(sum(st.missing)), 0)}, len(bad_calls))


def control(ctx, st: State, ref) -> dict:
    """The control in the program's place: the reference with the forward
    monomers alone (it breaks the guarantee that both strands are
    called), on the sampled reads of the window's calls."""
    want = _reference(ctx, st, ref, ("fwd", "rc"))
    ctl = _reference(ctx, st, ref, ("fwd",))
    kept = [(i, j, ctl[st.pool[j][0]]) for i, j, _ in st.kept] or \
        [(0, j, ctl[st.pool[j][0]]) for j in st.sample]
    wrong, _ = _compare(st, want, kept)
    return {"reads_wrong": (wrong, 0)}


@contextlib.contextmanager
def probes(ctx, st: State, probe):
    """The traced run's wrapper around each lockstep step's device call
    (windows up, K4, calls back): its span, the steps, and K4's work from
    the step's real windows, queries and columns."""
    from centroflye_tpu_torch.mono.string_decomposer import MonomerDecomposer
    orig = MonomerDecomposer._device_batch

    def device_batch(self, windows, lens, mode, collect="best"):
        ops, nbytes = roofline.perrow_work(
            lens, windows.shape[1], 2 * self.n, roofline.words(self.max_m),
            collect)
        probe.counters["steps"] += 1
        probe.counters["k4_ops"] += ops
        probe.counters["k4_bytes"] += nbytes
        with probe.span("decompose.device_batch"):
            return orig(self, windows, lens, mode, collect)

    MonomerDecomposer._device_batch = device_batch
    try:
        yield
    finally:
        MonomerDecomposer._device_batch = orig
