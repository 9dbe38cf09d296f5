"""Four-card drive of the PyTorch port (centroflye_tpu_torch) on four
distinct NVIDIA GPUs of one host: every sharded path of the port, held
against the same work on one card.

    python3 tools/multicard_smoke.py                  # needs 4 cards
    python3 tools/multicard_smoke.py --phases kernels_per_card,engine
    python3 tools/multicard_smoke.py --device cpu     # 4 CPU devices, small
    python3 tools/multicard_smoke.py --log runs/multicard.jsonl

On the cards it refuses to run with fewer than 4 (it never repeats one
card). Phases, one JSON line each:

- cards: each card's name and power limit (nvidia-smi), peer access
  between every pair, torch and CUDA versions; build: the kernels.
- kernels_per_card: one worker process a card, all at once. On card d
  K1 (two strands), K2 (each strand), K3 (k = 350), K4 (both of the
  decomposer's calls) and K5 (two chunks, the whole carried state) equal
  their plain versions on card d with max_abs_err 0, each launched while
  the process's current card is another one, and K1 once more on a
  non-default stream; the wrappers' per-card counts and the profiler's
  kernel records must name card d alone. K1's time on each card.
- engine: chip_smoke's main_path mix (bench.py's 8,192 reads, seed 0)
  through RecruitmentEngine(device="cuda", mesh="auto") over the four
  cards, prefilter on (native fill) and off: every read's (dist_fwd,
  dist_rc) equals a mesh=None run on cuda:0 (the exact tier's for the
  reads the sequence-parallel tier takes), the recruited set the exact
  tier's. K1 launched on every card with the prefilter (the fused step
  shards) and on cuda:0 alone without it (the exact tier runs on the
  mesh's first card); K5 on every card (the reads of at least
  seq_parallel_min_len). Seconds on 4 cards and on 1.
- seqpar: chip_smoke's 8 reads of 100-400 kb through the
  sequence-parallel tier over the four cards (4 column chunks, K5 on
  each): distances equal the single-card exact tier's; K5 on every
  card; one captured launch on the last card equals myers_carry_plain
  (on the CPU) on the whole carried state. The tier also on a mesh that
  repeats cuda:0 four times: the same work on one card.
- distributed: recruit_file(distributed=True) in 4 processes, one a
  card, from LOCAL_RANK / RANK / WORLD_SIZE: the merged file equals the
  single-process file byte for byte; each process reports its card, the
  four differ, and each launched K1 on its own card alone.
- dryrun: dryrun_multichip(4) on cuda:0..3.
- cen6: recruit_file with D6Z1 at 550 on chip_smoke.cen6_world's reads
  and the main_path mix, over the four cards and on one: the same file;
  then MonoPipeline.decompose(mesh="auto") on the recruited reads: the
  SDReport equals the single-card one; K1, K4 and (for the reads of at
  least seq_parallel_min_len) K5 on every card.
- cenx: CenXPipeline(mesh="auto").run on chip_smoke.make_world's
  production world (1,500 DXZ1 units, 52x) with main_path's background
  reads. Stage 2 resumes from the world's records and the decomposed
  boundary reads (the decomposition chip_smoke's pinned digests are of);
  every other stage runs. read_positions.csv, unit_star.fasta and
  final_assembly.fasta must have chip_smoke's PLACEMENT_DIGEST,
  UNIT_STAR_DIGEST and ASSEMBLY_DIGEST, and stage 3 run again on one card
  must write the same two artifacts. Each stage's seconds, and stage 3's
  on one card.
- overlap: one torch.profiler trace of one sharded fused step (captured
  in phase engine) and one stage-3 strip (the distance sweep's sharded
  pair-bucket step, captured in phase cenx) over the four cards: each
  card's kernel time, the time all four are busy at once, and the host
  synchronisations the trace shows. Measured, not checked.

The last line is {"ok": true, "cards": 4, "phase_seconds": {...}}. Any
failed check exits non-zero and prints no such line. With --device cpu
every phase runs at a small size on meshes of 4 CPU devices (the
kernels' plain versions; worlds from chip_smoke's CPU-sized helpers):
the equality checks hold, the checks that need a card (launch counts,
distinct cards, digests) are left out, and nothing is timed as a card."""

import argparse
import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402
from centroflye_tpu_torch.config import (  # noqa: E402
    CentroFlyeConfig, MonoConfig, RecruitmentConfig, UnitDecompositionConfig)
from centroflye_tpu_torch.io.encoding import encode  # noqa: E402
from centroflye_tpu_torch.io.fasta import (iter_seqs, read_seq,  # noqa: E402
                                           read_seqs, write_seqs)
from centroflye_tpu_torch.mono.pipeline import MonoPipeline  # noqa: E402
from centroflye_tpu_torch.mono.string_decomposer import (  # noqa: E402
    MonomerDecomposer)
from centroflye_tpu_torch.ops.myers import (build_peq,  # noqa: E402
                                            carry_init, myers_carry_plain,
                                            words_tensor)
from centroflye_tpu_torch.ops.myers_cuda import (  # noqa: E402
    PERROW_CALLS, myers_carry, myers_hw_2strand, myers_hw_chunks, myers_hw_v3,
    myers_hw_v3_banded, myers_perrow, myers_perrow_plain, reset_launches,
    threshold_hw)
from centroflye_tpu_torch.parallel import seq_parallel  # noqa: E402
from centroflye_tpu_torch.parallel.dryrun import (  # noqa: E402
    dryrun_multichip, warm_devices)
from centroflye_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from centroflye_tpu_torch.pipeline.cenx import (  # noqa: E402
    CenXPipeline, run_unique_kmers, save_decomposition)
from centroflye_tpu_torch.stages import distance_graph  # noqa: E402
from centroflye_tpu_torch.stages.recruitment import (  # noqa: E402
    RecruitmentEngine, recruit_file)
from centroflye_tpu_torch.stages.unit_decomposition import (  # noqa: E402
    UnitDecomposer)

CARDS = 4
K3_K = 350                   # K3's threshold on phase k1's batch
DIST_TIMEOUT_S = 600
# the seq-par tier's floor in recruit_file (cen6, cenx): the default
FILE_SEQPAR_MIN = RecruitmentConfig().seq_parallel_min_len
PHASES = ("kernels_per_card", "engine", "seqpar", "distributed", "dryrun",
          "cen6", "cenx", "overlap")


@dataclasses.dataclass
class Size:
    """What each phase runs on: the production shapes on the cards,
    small ones on the CPU."""
    unit: str                # stage 1's unit (DXZ1 on the cards)
    k_rows: int              # kernels_per_card's K1-K3 batch
    k_cols: int
    k4_windows: int
    k5_chunk: int
    n_reads: int             # the main_path mix
    max_read: int            # reads cut to this length (0: as made)
    batch: int
    seg_len: int
    threshold: int
    seqpar_min: int          # RecruitmentConfig.seq_parallel_min_len
    long_reads: int
    long_len: tuple
    long_seg: int            # the seq-par phase's segment length
    full_worlds: bool        # the production cenX and cen6 worlds


def full_size():
    return Size(unit=read_seq(cs.UNIT_FASTA), k_rows=cs.K_BUDGET,
                k_cols=cs.SEG_LEN, k4_windows=cs.K4_WINDOWS[0],
                k5_chunk=cs.K5_CHUNK, n_reads=cs.N_READS, max_read=0,
                batch=cs.BATCH_SIZE, seg_len=cs.SEG_LEN,
                threshold=cs.THRESHOLD,
                seqpar_min=FILE_SEQPAR_MIN,
                long_reads=cs.LONG_READS, long_len=cs.LONG_LEN,
                long_seg=cs.PIPELINE_SEG_LEN, full_worlds=True)


def small_size():
    from centroflye_tpu_torch.pipeline.simulate import gen_random_seq
    return Size(unit=gen_random_seq(np.random.default_rng(3), 200),
                k_rows=16, k_cols=512, k4_windows=12, k5_chunk=256,
                n_reads=24, max_read=1000, batch=64, seg_len=1024,
                threshold=50, seqpar_min=1500, long_reads=3,
                long_len=(1600, 2400), long_seg=1024, full_worlds=False)


LOG = []                     # a file that gets every line as well


def emit(obj):
    line = json.dumps(obj)
    print(line, flush=True)
    for fn in LOG:
        with open(fn, "a") as f:
            f.write(line + "\n")


def check(cond, msg):
    if not cond:
        raise SystemExit(f"multicard_smoke: FAILED: {msg}")


def sync(devices):
    for d in dict.fromkeys(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def by_card(wrapper, devices):
    """The wrapper's launches on each of `devices`, in mesh order."""
    return [wrapper.launches_by_device.get(d.index, 0) for d in devices]


class Run:
    """The run's devices and sizes: on the cards cuda:0..3 and "auto"
    meshes; on the CPU four CPU devices and an explicit mesh."""

    def __init__(self, device):
        self.cuda = device == "cuda"
        self.size = full_size() if self.cuda else small_size()
        if self.cuda:
            self.devices = [torch.device("cuda", i) for i in range(CARDS)]
            self.mesh = "auto"
        else:
            self.devices = [torch.device("cpu")] * CARDS
            self.mesh = make_mesh(CARDS, devices=self.devices)
        self.one = self.devices[0]      # the single-card runs' device
        self.device = "cuda" if self.cuda else "cpu"
        self.captured = {}              # overlap's inputs

    def resolved_mesh(self, got):
        """The mesh an "auto" entry point took: it must be the four
        cards, in order."""
        check(got is not None and list(got.devices) == self.devices,
              f"mesh='auto' gave {got}, not {self.devices}")
        return got

    def sync(self):
        sync(self.devices)


# ---------------------------------------------------------------- cards
def phase_cards(run):
    t0 = time.perf_counter()
    if not run.cuda:
        emit({"phase": "cards", "device": "cpu", "devices": CARDS,
              "seconds": time.perf_counter() - t0})
        return None
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    n = torch.cuda.device_count()
    check(n >= CARDS, f"{n} CUDA device(s): this drive needs {CARDS} "
          f"distinct cards and never repeats one")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    lines = smi.stdout.strip().splitlines()
    peer = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
            for a in range(CARDS) for b in range(CARDS) if a != b}
    emit({"phase": "cards", "count": n, "nvidia_smi": lines,
          "names": [torch.cuda.get_device_name(i) for i in range(n)],
          "peer_access": peer, "torch": torch.__version__,
          "cuda": torch.version.cuda, "seconds": time.perf_counter() - t0})
    return lines


def phase_build(run):
    if run.cuda:
        cs.phase_build()


# ----------------------------------------------------- kernels_per_card
def profiled_kernel_cards(fn, devices):
    """Runs fn() under torch.profiler, `devices` synchronised -> (fn's
    result, {card index: kernels}) of the CUDA kernels the trace holds
    ({} if it holds none)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        sync(devices)
    cards = {}
    for e in kernel_events(prof.events()):
        cards[e[0]] = cards.get(e[0], 0) + 1
    return out, cards


def kernel_events(events):
    """[(card, start us, end us, name)] of a trace's device kernels."""
    from torch.autograd import DeviceType
    out = []
    for e in events:
        if e.device_type == DeviceType.CUDA and e.time_range.end > \
                e.time_range.start and not e.name.startswith("Memcpy") \
                and not e.name.startswith("Memset"):
            out.append((e.device_index, e.time_range.start,
                        e.time_range.end, e.name))
    return out


def card_worker(card, device):
    """kernels_per_card's body on card `card` (one process a card): the
    fields of its JSON line."""
    run = Run(device)
    size = run.size
    dev = run.devices[card]
    other = run.devices[(card + 1) % CARDS]
    if run.cuda:
        torch.cuda.set_device(other)     # the process's card is another
    guard = (lambda: torch.cuda.device(other)) if run.cuda else \
        contextlib.nullcontext
    rng = np.random.default_rng(1)
    unit_codes = encode(size.unit)
    m = len(unit_codes)
    reset_launches()
    t0 = time.perf_counter()
    args = cs.k1_case(rng, unit_codes, m, size.k_cols, size.k_rows, dev)
    pf, pr, text_t, lens = args
    want = cs.plain_both_strands(*args, m=m)
    plain_s = time.perf_counter() - t0
    strand = {"f": (pf, "dist_f", "end_f"), "r": (pr, "dist_r", "end_r")}

    monomers = read_seqs(cs.D6Z1_MONOMERS)
    dec = MonomerDecomposer(monomers, device=dev)
    windows, wlens = cs.k4_rows(rng, monomers, size.k4_windows, dec.window,
                                dev)
    k4_want = {call: myers_perrow_plain(dec.queries, windows, wlens,
                                        mode=call[0], collect=call[1])
               for call in PERROW_CALLS}
    C = size.k5_chunk
    codes5, lens5 = cs.k5_case(rng, unit_codes, C)
    text5 = torch.from_numpy(codes5).to(dev)
    lens5 = torch.from_numpy(lens5).to(dev)
    peq = words_tensor(build_peq(unit_codes), dev)
    k5_plain = [carry_init(text5.shape[0], m, dev)]
    for c in range(2):
        k5_plain.append(myers_carry_plain(peq, text5[:, c * C:(c + 1) * C],
                                          lens5, k5_plain[-1], c * C, m=m))

    def launches():
        """One launch of every kernel, each inside the guard: their
        outputs."""
        out = {}
        with guard():
            out["k1"] = myers_hw_2strand(*args, m=m)
        for s, (p, _, _) in strand.items():
            with guard():
                out[f"k2_{s}"] = myers_hw_v3(p, text_t, lens, m=m)
            with guard():
                out[f"k3_{s}"] = myers_hw_v3_banded(p, text_t, lens, m=m,
                                                    k=K3_K)
        for call in PERROW_CALLS:
            with guard():
                out["k4_" + "/".join(call)] = myers_perrow(
                    dec.queries, windows, wlens, mode=call[0],
                    collect=call[1])
        state = carry_init(text5.shape[0], m, dev)
        for c in range(2):
            with guard():
                state = myers_carry(peq, text5[:, c * C:(c + 1) * C],
                                    lens5, state, c * C, m=m)
            out[f"k5_{c}"] = state
        if run.cuda:
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with guard(), torch.cuda.stream(stream):
                out["k1_stream"] = myers_hw_2strand(*args, m=m)
            torch.cuda.current_stream(dev).wait_stream(stream)
        return out

    if run.cuda:
        got, cards = profiled_kernel_cards(launches, [dev, other])
    else:
        got, cards = launches(), {}
    errs = {}
    for key in ("k1", "k1_stream"):
        if key in got:
            errs[key] = cs.max_abs_err(got[key], want)
    for s, (_, dk, ek) in strand.items():
        one = {"dist": want[dk], "end": want[ek]}
        errs[f"k2_{s}"] = cs.max_abs_err(got[f"k2_{s}"], one)
        errs[f"k3_{s}"] = cs.max_abs_err(got[f"k3_{s}"],
                                         threshold_hw(one, m=m, k=K3_K))
    for call in PERROW_CALLS:
        key = "k4_" + "/".join(call)
        errs[key] = cs.max_abs_err(got[key], k4_want[call])
    for c in range(2):
        errs[f"k5_{c}"] = cs.state_err(got[f"k5_{c}"], k5_plain[c + 1])
    counts = {w.__name__: dict(w.launches_by_device) for w in (
        myers_hw_2strand, myers_hw_v3, myers_hw_v3_banded, myers_perrow,
        myers_carry)}
    fields = {"card": card, "device": str(dev), "current_card": str(other),
              "max_abs_err": errs, "launches_by_card": counts,
              "profiled_kernels_by_card": cards,
              "plain_k1_seconds": plain_s}
    if run.cuda:
        with torch.cuda.device(dev):
            fields["k1_ms"] = cs.time_cuda(
                lambda: myers_hw_2strand(*args, m=m), reps=20)
        fields["name"] = torch.cuda.get_device_name(dev)
    fields["seconds"] = time.perf_counter() - t0
    return fields


def phase_kernels_per_card(run):
    """One worker process a card, all started together; each must find
    every kernel equal to its plain version on its card, and every launch
    counted (and, where the profiler traced the card, run) there."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=HERE)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--device", run.device,
         "--card-worker", str(c)], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for c in range(CARDS)]
    outs = communicate_all(procs, DIST_TIMEOUT_S)
    cards = []
    for c, (p, (out, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"card {c}'s kernel worker failed: "
              f"{err[-3000:]}")
        cards.append(json.loads(out.strip().splitlines()[-1]))
    for c, f in enumerate(cards):
        bad = {k: v for k, v in f["max_abs_err"].items() if v != 0}
        check(not bad, f"card {c}: kernels differ from their plain "
              f"versions: {bad}")
        if run.cuda:
            counts = f["launches_by_card"]
            check(all(list(v) == [str(c)] for v in counts.values())
                  and all(counts.values()),
                  f"card {c}: launches counted on {counts}")
            traced = f["profiled_kernels_by_card"]
            check(not traced or list(traced) == [str(c)],
                  f"card {c}: the profiler saw its kernels on {traced}")
    emit({"phase": "kernels_per_card", "cards": cards,
          "seconds": time.perf_counter() - t0})


def communicate_all(procs, timeout):
    """Every process's (stdout, stderr); ends any still running."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


# ---------------------------------------------------------------- engine
def main_path_reads(run):
    """chip_smoke's main_path mix (bench.py's, seed 0); on the CPU its
    first n_reads, each cut to max_read bases, every tenth to twice that
    (they take the sequence-parallel tier)."""
    reads, cen = cs.make_reads(run.size.unit, run.size.n_reads)
    if run.size.max_read:
        reads = [(r, s[:run.size.max_read * (2 if i % 10 == 5 else 1)])
                 for i, (r, s) in enumerate(reads)]
    return reads, cen


def engine_run(run, reads, cfg, mesh, device, capture=None):
    """One engine run -> ([(r_id, dist_fwd, dist_rc, recruited)],
    seconds, the engine)."""
    engine = RecruitmentEngine(run.size.unit, cfg, seg_len=run.size.seg_len,
                               device=device, mesh=mesh)
    if capture is not None:
        raw = engine._fused.raw

        def keep(packed, n_mask, lens):
            if not capture:
                capture.append((np.copy(packed), n_mask, np.copy(lens)))
            return raw(packed, n_mask, lens)
        engine._fused.raw = keep
    run.sync()
    t = time.perf_counter()
    out = [(r.r_id, r.dist_fwd, r.dist_rc, r.recruited)
           for r in engine.run(reads)]
    run.sync()
    return out, time.perf_counter() - t, engine


def phase_engine(run):
    """The main_path mix through the engine over the four cards and on
    one, prefilter on and off; the 4-card and 1-card runs alternate
    (1, 4, 4, 1) for their seconds."""
    t0 = time.perf_counter()
    size = run.size
    if run.cuda:
        warm_devices(run.devices)
    reads, cen = main_path_reads(run)
    gen_s = time.perf_counter() - t0
    cfgs = {"prefilter": RecruitmentConfig(
        threshold=size.threshold, batch_size=size.batch,
        seq_parallel_min_len=size.seqpar_min),
        "exact": RecruitmentConfig(
            threshold=size.threshold, batch_size=size.batch,
            prefilter=False, seq_parallel_min_len=size.seqpar_min)}
    out, fused_in = {}, []
    results = {}
    for name, cfg in cfgs.items():
        secs = {"one": [], "four": []}
        for where in ("one", "four", "four", "one"):
            reset_launches()
            if where == "one":
                got, s, eng = engine_run(run, reads, cfg, None, run.one)
                check(eng.mesh is None, "mesh=None took a mesh")
            else:
                got, s, eng = engine_run(
                    run, reads, cfg, run.mesh, run.device,
                    capture=fused_in if name == "prefilter" else None)
                mesh = run.resolved_mesh(eng.mesh)
                k1 = by_card(myers_hw_2strand, mesh.devices)
                k1c = by_card(myers_hw_chunks, mesh.devices)
                k5 = by_card(myers_carry, mesh.devices)
                seqpar_ids = {r for r, sq in reads
                              if len(sq) >= eng.seqpar_min}
            secs[where].append(s)
            results.setdefault((name, where), got)
            check(results[name, where] == got,
                  f"{name}: two {where}-card runs differ")
        out[name] = {"seconds_one_card": secs["one"],
                     "seconds_four_cards": secs["four"],
                     "k1_launches_by_card": k1, "k1c_launches_by_card": k1c,
                     "k5_launches_by_card": k5,
                     "seqpar_reads": len(seqpar_ids)}
        if run.cuda:
            # the fused step (K1c) shards; the exact tier (K1) runs on the
            # mesh's first card; the long reads' seq-par tier on every card
            k1_ok = all(k1c) if cfg.prefilter else (
                k1[0] > 0 and not any(k1[1:]))
            check(k1_ok and all(k5), f"{name}: K1 launched {k1}, K1c "
                  f"{k1c}, K5 {k5} times by card")
    one_p, four_p = results["prefilter", "one"], results["prefilter", "four"]
    one_x, four_x = results["exact", "one"], results["exact", "four"]
    want_p = [x if x[0] in seqpar_ids else p for p, x in zip(one_p, one_x)]
    check(four_p == want_p, "prefilter on: the 4-card distances differ: "
          f"{[(a, b) for a, b in zip(four_p, want_p) if a != b][:5]}")
    check(four_x == one_x, "prefilter off: the 4-card distances differ: "
          f"{[(a, b) for a, b in zip(four_x, one_x) if a != b][:5]}")
    exact_set = {r for r, _, _, rec in one_x if rec}
    got_set = {r for r, _, _, rec in four_p if rec}
    check(got_set == exact_set, "the 4-card recruited set differs from "
          f"the exact tier's: {sorted(got_set ^ exact_set)[:10]}")
    if run.cuda:
        check(exact_set == cen, f"recruited {sorted(exact_set ^ cen)[:10]} "
              "unlike the mix's centromeric reads")
    run.captured["fused"] = fused_in
    mbp = sum(len(s) for _, s in reads) / 1e6
    emit({"phase": "engine", "reads": len(reads), "mbp": mbp,
          "recruited": len(got_set), "equal": True, "runs": out,
          "make_reads_seconds": gen_s, "seconds": time.perf_counter() - t0})
    return reads, got_set


# ---------------------------------------------------------------- seqpar
def long_reads(run):
    """chip_smoke's long reads (LONG_SEED, tandem at even indices); on
    the CPU fewer and shorter."""
    if run.size.full_worlds:
        return cs.long_reads(run.size.unit)
    from centroflye_tpu_torch.pipeline.simulate import (add_read_noise,
                                                        gen_random_seq)
    rng = np.random.default_rng(cs.LONG_SEED)
    unit, reads = run.size.unit, []
    for i in range(run.size.long_reads):
        L = int(rng.integers(*run.size.long_len))
        seq = (add_read_noise(rng, unit * (L // len(unit) + 2), 0.10)[:L]
               if i % 2 == 0 else gen_random_seq(rng, L))
        reads.append((f"long{i}", seq))
    return reads, {r for i, (r, _) in enumerate(reads) if i % 2 == 0}


def phase_seqpar(run):
    t0 = time.perf_counter()
    size = run.size
    longs, tandem = long_reads(run)
    cfg = RecruitmentConfig(threshold=size.threshold, batch_size=size.batch,
                            prefilter=False,
                            seq_parallel_min_len=size.seqpar_min)

    def go(mesh, device):
        eng = RecruitmentEngine(size.unit, cfg, seg_len=size.long_seg,
                                device=device, mesh=mesh)
        run.sync()
        t = time.perf_counter()
        got = [(r.r_id, r.dist_fwd, r.dist_rc, r.recruited)
               for r in eng.run(longs)]
        run.sync()
        return got, time.perf_counter() - t, eng

    want, seg_s, _ = go(None, run.one)
    one_card = make_mesh(CARDS, devices=[run.one] * CARDS)
    secs = {"segmented_one_card": seg_s, "tier_one_card": [],
            "tier_four_cards": []}
    for where in ("one", "four", "four", "one"):
        reset_launches()
        if where == "four":
            with cs.captured_seqpar_k5() as kept:
                got, s, eng = go(run.mesh, run.device)
            mesh = run.resolved_mesh(eng.mesh)
            k5 = by_card(myers_carry, mesh.devices)
            launches = kept
            check(min(len(sq) for _, sq in longs) >= eng.seqpar_min,
                  "the long reads do not take the sequence-parallel tier")
        else:
            got, s, _ = go(one_card, run.one)
        secs[f"tier_{'one_card' if where == 'one' else 'four_cards'}"
             ].append(s)
        check(got == want, f"seq-par ({where} card(s)) {got} != the "
              f"single-card exact tier's {want}")
    check({r for r, _, _, rec in got if rec} == tandem,
          f"seq-par recruited {[r for r, _, _, rec in got if rec]}")
    if run.cuda:
        check(all(k5), f"K5 launched {k5} times by card")
    # one launch on the last card, held whole against the plain version
    last = run.devices[-1]
    on_last = [k for k in launches if k[0][1].device == last
               and bool((k[0][2] > k[0][4]).any())]
    check(on_last, f"no K5 launch with an active row on {last}")
    args, kw, state_out = max(on_last, key=lambda k: (
        int(k[2].best.min()) <= size.threshold, k[0][4]))
    peq, text, lens, state, c0 = args
    t = time.perf_counter()
    want_state = myers_carry_plain(peq.cpu(), text.cpu(), lens.cpu(),
                                   state.to("cpu"), c0, **kw)
    plain_s = time.perf_counter() - t
    err = cs.state_err(state_out, want_state)
    check(err == 0, f"K5 on {last} != its plain version at c0 = {c0}")
    emit({"phase": "seqpar", "reads": len(longs),
          "mbp": sum(len(s) for _, s in longs) / 1e6, "equal": True,
          "k5_launches_by_card": k5, "launches_captured": len(launches),
          "held_launch": {"device": str(last), "c0": c0,
                          "shape": list(text.shape), "max_abs_err": err,
                          "plain_cpu_seconds": plain_s},
          "tier_seconds": secs, "seconds": time.perf_counter() - t0})


# ----------------------------------------------------------- distributed
def dist_worker(unit_fn, reads_fn, out_fn, threshold, batch, seg_len,
                device):
    """One process of the distributed phase: joins the group from the
    environment, recruits its share on its own card -> its JSON line."""
    import torch.distributed as dist

    from centroflye_tpu_torch.parallel.distributed import (
        init_distributed, local_device, process_index)
    t = time.perf_counter()
    check(init_distributed(), "init_distributed joined no group")
    reset_launches()
    n = recruit_file(unit_fn, reads_fn, out_fn, int(threshold),
                     batch_size=int(batch), seg_len=int(seg_len),
                     device=device, distributed=True)
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    fields = {"rank": process_index(),
              "local_device": str(local_device()) if cuda else "cpu",
              "current": torch.cuda.current_device() if cuda else None,
              "recruited": n,
              "k1_launches_by_card": dict(myers_hw_2strand.launches_by_device),
              "k1c_launches_by_card": dict(
                  myers_hw_chunks.launches_by_device),
              "seconds": time.perf_counter() - t}
    dist.destroy_process_group()
    return fields


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_distributed(run, reads):
    t0 = time.perf_counter()
    size = run.size
    with tempfile.TemporaryDirectory() as tmp:
        unit_fn = os.path.join(tmp, "unit.fasta")
        write_seqs(unit_fn, {"unit": size.unit})
        reads_fn = os.path.join(tmp, "reads.fasta")
        write_seqs(reads_fn, dict(reads))
        single_fn = os.path.join(tmp, "single.fasta")
        t = time.perf_counter()
        n_single = recruit_file(unit_fn, reads_fn, single_fn, size.threshold,
                                batch_size=size.batch, seg_len=size.seg_len,
                                device=run.one, mesh=None)
        run.sync()
        single_s = time.perf_counter() - t
        out_fn = os.path.join(tmp, "distributed.fasta")
        port = str(free_port())
        t = time.perf_counter()
        procs = []
        for rank in range(CARDS):
            env = dict(os.environ, PYTHONPATH=HERE, MASTER_ADDR="localhost",
                       MASTER_PORT=port, RANK=str(rank),
                       WORLD_SIZE=str(CARDS), LOCAL_RANK=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--device",
                 run.device, "--dist-worker", unit_fn, reads_fn, out_fn,
                 str(size.threshold), str(size.batch), str(size.seg_len)],
                cwd=HERE, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        outs = communicate_all(procs, DIST_TIMEOUT_S)
        dist_s = time.perf_counter() - t
        for p, (_, err) in zip(procs, outs):
            check(p.returncode == 0, f"a distributed process failed: "
                  f"{err[-3000:]}")
        workers = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
        same = cs.sha256_of(single_fn) == cs.sha256_of(out_fn)
    check(workers[0]["recruited"] == n_single > 0 and same,
          f"{CARDS} processes wrote {workers[0]['recruited']} reads, one "
          f"wrote {n_single}; files equal: {same}")
    if run.cuda:
        cards = [w["local_device"] for w in workers]
        check(len(set(cards)) == CARDS, f"the processes ran on {cards}")
        for w in workers:
            idx = w["local_device"].split(":")[1]
            check(w["current"] == int(idx) and set(
                w["k1_launches_by_card"]) | set(
                    w["k1c_launches_by_card"]) <= {idx},
                  f"process {w['rank']} on {w['local_device']} launched K1 "
                  f"on {w['k1_launches_by_card']}, K1c on "
                  f"{w['k1c_launches_by_card']}, current card "
                  f"{w['current']}")
        check(sum(sum(w[k].values()) for w in workers
                  for k in ("k1_launches_by_card", "k1c_launches_by_card"))
              > 0, "no process launched K1 or K1c")
    emit({"phase": "distributed", "processes": CARDS, "reads": len(reads),
          "recruited": n_single, "identical": True, "workers": workers,
          "single_process_seconds": single_s,
          "processes_seconds": dist_s, "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------- dryrun
def phase_dryrun(run):
    t0 = time.perf_counter()
    out = dryrun_multichip(CARDS, None if run.cuda else run.devices)
    if run.cuda:
        check(out["devices"] == [str(d) for d in run.devices],
              f"the dry run ran on {out['devices']}")
    emit({"phase": "dryrun", **out, "seconds": time.perf_counter() - t0})


# ------------------------------------------------------------------ cen6
def sd_records(sd):
    return {r: (ms.syms.tolist(), ms.nucl.tolist(), ms.strand)
            for r, ms in sd.monostrings.items()}


def cen6_inputs(run, reads):
    """(unit, threshold, monomers, the world's reads, the background
    reads): D6Z1 at 550, cen6_world and main_path's mix on the cards; on
    the CPU chip_smoke's mono_fresh_world with its HOR as the unit and a
    few of the small mix's reads."""
    if run.size.full_worlds:
        world = cs.cen6_world()
        return (read_seq(cs.D6Z1_FASTA), cs.CEN6_THRESHOLD, world.monomers,
                world.reads, reads)
    monomers, _, _, mreads = cs.mono_fresh_world()
    hor = "".join(monomers.values())
    return hor, len(hor) // 3, monomers, list(mreads.items()), reads[:8]


def phase_cen6(run, reads):
    t0 = time.perf_counter()
    unit, threshold, monomers, world_reads, background = cen6_inputs(
        run, reads)
    world_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        unit_fn = os.path.join(tmp, "unit.fasta")
        write_seqs(unit_fn, {"unit": unit})
        reads_fn = os.path.join(tmp, "reads.fasta")
        seqs = dict(world_reads)
        seqs.update(background)
        write_seqs(reads_fn, seqs)
        mbp = sum(map(len, seqs.values())) / 1e6
        n_long = sum(len(q) >= FILE_SEQPAR_MIN
                     for q in seqs.values())
        del seqs
        files, secs = {}, {}
        for where in ("one", "four"):
            fn = os.path.join(tmp, f"cen_{where}.fasta")
            reset_launches()
            run.sync()
            t = time.perf_counter()
            n = recruit_file(unit_fn, reads_fn, fn, threshold,
                             device=run.one if where == "one"
                             else run.device,
                             mesh=None if where == "one" else run.mesh)
            run.sync()
            secs[f"recruit_{where}"] = time.perf_counter() - t
            files[where] = (cs.sha256_of(fn), n)
            if where == "four":
                k1c = by_card(myers_hw_chunks, run.devices)
                k5 = by_card(myers_carry, run.devices)
        check(files["one"] == files["four"] and files["one"][1] > 0,
              f"cen6 recruitment: 4 cards {files['four']}, one "
              f"{files['one']}")
        recruited = list(iter_seqs(os.path.join(tmp, "cen_four.fasta")))
        world_ids = {r for r, _ in world_reads}
        check({r for r, _ in recruited} == world_ids,
              "cen6 recruitment: not the world's reads")
        sds = {}
        for where in ("one", "four"):
            pipe = MonoPipeline(MonoConfig(), os.path.join(tmp, where),
                                device=run.one if where == "one"
                                else run.device)
            reset_launches()
            run.sync()
            t = time.perf_counter()
            sd = pipe.decompose(monomers, recruited,
                                mesh=None if where == "one" else run.mesh)
            run.sync()
            secs[f"decompose_{where}"] = time.perf_counter() - t
            sds[where] = sd_records(sd)
            if where == "four":
                k4 = by_card(myers_perrow, run.devices)
        check(sds["one"] == sds["four"],
              "cen6: the 4-card SDReport differs from the single card's")
    if run.cuda:
        # reads of at least seq_parallel_min_len take the seq-par tier
        check(all(k1c) and all(k4) and (all(k5) or not n_long),
              f"cen6: K1c {k1c}, K4 {k4}, K5 {k5} launches by card "
              f"({n_long} reads for the seq-par tier)")
    emit({"phase": "cen6", "reads": len(world_reads) + len(background),
           "mbp": mbp, "recruited": files["one"][1],
           "identical_file": True, "sd_equal": True,
           "monostrings": len(sds["one"]), "k1c_launches_by_card": k1c,
           "k4_launches_by_card": k4, "k5_launches_by_card": k5,
           "seqpar_reads": n_long, "world_seconds": world_s,
           "phase_seconds": secs, "seconds": time.perf_counter() - t0})


# ------------------------------------------------------------------ cenx
@contextlib.contextmanager
def captured_strip():
    """The first sharded pair-bucket step of the distance sweep whose
    strip is the largest so far, with its arguments (kept by reference),
    for the overlap trace."""
    kept, make = [], distance_graph.make_pair_bucket_step

    def make_kept(mesh, *, chunk, capacity):
        step = make(mesh, chunk=chunk, capacity=capacity)

        def kept_step(*args):
            if not kept or chunk > kept[0][2]:
                kept[:] = [(step, args, chunk)]
            return step(*args)
        return kept_step
    distance_graph.make_pair_bucket_step = make_kept
    try:
        yield kept
    finally:
        distance_graph.make_pair_bucket_step = make


def cenx_inputs(run, background):
    """(unit, config, the reads {id: seq}, a Decomposition to resume stage
    2 from or None, the digests wanted or None)."""
    if run.size.full_worlds:
        unit = run.size.unit
        world = cs.make_world(unit, cs.N_UNITS)
        bdec = UnitDecomposer(unit, UnitDecompositionConfig()).decompose(
            world.boundary)
        dec = cs.merge_decompositions(world.dec, bdec)
        reads = {r: rec.seq for r, rec in sorted(world.dec.records.items())}
        reads.update(world.boundary)
        reads.update(background)
        return (unit, CentroFlyeConfig(), reads, dec,
                {"tr_resolution/read_positions.csv": cs.PLACEMENT_DIGEST,
                 "cons_unit/unit_star.fasta": cs.UNIT_STAR_DIGEST,
                 "final_assembly.fasta": cs.ASSEMBLY_DIGEST})
    unit, _, reads = cs.fresh_world()
    return unit, cs.fresh_config(), reads, None, None


def phase_cenx(run, background):
    t0 = time.perf_counter()
    unit, cfg, reads, dec, want = cenx_inputs(run, background)
    world_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        outdir = os.path.join(tmp, "out")
        os.makedirs(outdir)
        reads_fn = os.path.join(tmp, "reads.fasta")
        write_seqs(reads_fn, reads)
        mbp = sum(map(len, reads.values())) / 1e6
        n_long = sum(len(q) >= FILE_SEQPAR_MIN
                     for q in reads.values())
        del reads
        if dec is not None:
            save_decomposition(dec, os.path.join(outdir,
                                                 "decomposition.json"))
        seconds, calls = {}, {}
        pipe = CenXPipeline(unit, cfg, outdir, device=run.device,
                            mesh=run.mesh)
        mesh = pipe.mesh if not run.cuda else run.resolved_mesh(pipe.mesh)
        cs.timed_pipeline(pipe, seconds, calls)
        reset_launches()
        t = time.perf_counter()
        with captured_strip() as strip:
            pipe.run(reads_fn)
        run.sync()
        run_s = time.perf_counter() - t
        k1c = by_card(myers_hw_chunks, mesh.devices)
        k5 = by_card(myers_carry, mesh.devices)
        run.captured["strip"] = strip
        digests = {name: cs.sha256_of(os.path.join(outdir, name))
                   for name in ("tr_resolution/read_positions.csv",
                                "cons_unit/unit_star.fasta",
                                "final_assembly.fasta")}
        arts = cs.read_artifacts(outdir, cfg.kmer_recruitment.min_coverage)
        # stage 3 again, on one card, on the Decomposition it ran on
        one = os.path.join(tmp, "one")
        t = time.perf_counter()
        run_unique_kmers(calls["run_unique_kmers"][0], cfg.kmer_recruitment,
                         cfg.coverage, one, run.one, mesh=None)
        run.sync()
        stage3_one = time.perf_counter() - t
        same3 = cs.read_artifacts(one, cfg.kmer_recruitment.min_coverage) \
            == arts
    check(same3, "stage 3 on four cards and on one wrote different "
          "artifacts")
    if run.cuda:
        check(all(k1c) and (all(k5) or not n_long), f"the cenX pipeline "
              f"launched K1c {k1c}, K5 {k5} times by card ({n_long} reads "
              "for the seq-par tier)")
    if want is not None:
        bad = {k: digests[k] for k in want if digests[k] != want[k]}
        check(not bad, f"the 4-card cenX pipeline's files differ from the "
              f"pinned digests: {bad}")
    emit({"phase": "cenx", "reads_mbp": mbp, "devices": [
        str(d) for d in mesh.devices], "stage_seconds": seconds,
        "run_seconds": run_s, "stage3_one_card_seconds": stage3_one,
        "stage3_identical": True, "sha256": digests,
        "pinned": want is not None, "k1c_launches_by_card": k1c,
        "k5_launches_by_card": k5, "seqpar_reads": n_long,
        "world_seconds": world_s, "seconds": time.perf_counter() - t0})


# --------------------------------------------------------------- overlap
def busy_union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def all_busy(unions):
    """Microseconds in which every union is busy at once."""
    events = []
    for u in unions:
        for a, b in u:
            events += [(a, 1), (b, -1)]
    n, last, total = 0, None, 0.0
    for t, d in sorted(events, key=lambda e: (e[0], e[1])):
        if n == len(unions) and last is not None:
            total += t - last
        n += d
        last = t
    return total


# the host calls that wait for a card: synchronisations, copies (pageable
# ones wait for the copy), readbacks of one value
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy",
              "aten::_local_scalar_dense")


def trace_overlap(run, fn):
    """fn() under torch.profiler: each card's kernel time and span, the
    time all cards are busy at once, and the host's synchronising calls
    (pageable copies and readbacks included) by name."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.cuda
                                     else [])
    run.sync()
    t = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        run.sync()
    wall = time.perf_counter() - t
    events = prof.events()
    kern = kernel_events(events)
    cards = sorted({k[0] for k in kern})
    unions = [busy_union([(a, b) for c, a, b, _ in kern if c == card])
              for card in cards]
    syncs = {}
    for e in events:
        if any(e.name.startswith(s) for s in SYNC_CALLS):
            syncs[e.name] = syncs.get(e.name, 0) + 1
    t_all = [a for a, _ in sum(unions, [])] + [b for _, b in sum(unions, [])]
    return {"wall_seconds": wall, "cards_traced": cards,
            "kernels": len(kern),
            "busy_ms_by_card": [sum(b - a for a, b in u) / 1e3
                                for u in unions],
            "span_ms_by_card": [(u[-1][1] - u[0][0]) / 1e3 for u in unions],
            "trace_span_ms": (max(t_all) - min(t_all)) / 1e3 if t_all
            else None,
            "all_cards_busy_ms": all_busy(unions) / 1e3
            if len(cards) == CARDS else 0.0,
            "host_syncs": syncs}


def phase_overlap(run):
    t0 = time.perf_counter()
    out = {}
    fused = run.captured.get("fused")
    strip = run.captured.get("strip")
    if fused:
        size = run.size
        eng = RecruitmentEngine(size.unit, RecruitmentConfig(
            threshold=size.threshold, batch_size=size.batch,
            seq_parallel_min_len=size.seqpar_min), seg_len=size.seg_len,
            device=run.device, mesh=run.mesh)
        packed, n_mask, lens = fused[0]
        if not run.cuda:        # no kernel to trace: a 4 x 64 corner
            packed = np.ascontiguousarray(packed[:CARDS, :16])
            lens = np.minimum(lens[:CARDS], 64)
        eng._fused.raw(packed, n_mask, lens)          # warm
        out["fused_step"] = {"rows": int(lens.shape[0]), **trace_overlap(
            run, lambda: eng._fused.raw(packed, n_mask, lens).cpu())}
    if strip:
        step, args, chunk = strip[0]
        step(*args)
        out["stage3_strip"] = {"pairs": chunk, **trace_overlap(
            run, lambda: step(*args))}
    check(fused or "fused" not in run.captured,
          "phase engine ran and captured no fused step")
    emit({"phase": "overlap", **out, "seconds": time.perf_counter() - t0})


# ------------------------------------------------------------------ main
def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES))
    parser.add_argument("--log", help="append every JSON line to this "
                        "file too, as it is printed")
    parser.add_argument("--card-worker", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--dist-worker", nargs=6, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.card_worker is not None:
        emit(card_worker(args.card_worker, args.device))
        return
    if args.dist_worker is not None:
        emit(dist_worker(*args.dist_worker, args.device))
        return
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)), exist_ok=True)
        LOG.append(args.log)
    phases = [p for p in args.phases.split(",") if p]
    bad = sorted(set(phases) - set(PHASES))
    check(not bad, f"unknown phases {bad}")
    t_start = time.perf_counter()
    run = Run(args.device)
    seconds = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t
        return out

    smi = timed("cards", phase_cards, run)
    timed("build", phase_build, run)
    if "kernels_per_card" in phases:
        timed("kernels_per_card", phase_kernels_per_card, run)
    reads = recruited = None
    if {"engine", "distributed", "cen6", "cenx"} & set(phases):
        if "engine" in phases:
            reads, recruited = timed("engine", phase_engine, run)
        else:
            reads, cen = main_path_reads(run)
            recruited = cen
    if "seqpar" in phases:
        timed("seqpar", phase_seqpar, run)
    if "distributed" in phases:
        timed("distributed", phase_distributed, run, reads)
    if "dryrun" in phases:
        timed("dryrun", phase_dryrun, run)
    if "cen6" in phases:
        timed("cen6", phase_cen6, run, reads)
    if "cenx" in phases:
        background = [(r, s) for r, s in reads if r not in recruited]
        timed("cenx", phase_cenx, run, background)
    if "overlap" in phases:
        timed("overlap", phase_overlap, run)
    if smi:
        print("\n".join(smi), flush=True)
    emit({"ok": True, "cards": CARDS, "device": args.device,
          "phases": phases, "phase_seconds": seconds,
          "seconds": time.perf_counter() - t_start})


if __name__ == "__main__":
    main()
