"""On-card smoke run of the PyTorch port (centroflye_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels from csrc/, holds each against its
plain PyTorch version at the main path's shapes (K1 two-strand, K2
one-strand and K3 threshold-k banded HW Myers), then drives read
recruitment (stage 1 of cenX) on the real DXZ1 unit and a rel2-matched
read mix, its file CLI, and the Myers op library's HW entry points (K2,
K3) on the exact tier's batches of that mix. K1 and K2 are one wavefront
kernel in instances of G = 8 and 32 lanes per (row, strand): every
instance is held against the plain version and timed at 128 x 10240
(phases k1, k2) and at 2048 x 10240 (phase myers_ops, where the
wrapper's instance is held against the plain version on exact-tier
batch 0), beside the instance the wrapper picks. Each kernel is listed with its bound: the
larger of its operations over the card's INT32 rate at the maximum SM
clock and its bytes over the memory rate. Last, phase unique_kmers drives
stage 3 of cenX (rare k-mers, then the distance-graph unique k-mers,
through pipeline/cenx.run_unique_kmers; plain PyTorch on the card, no
kernel of its own) on a simulated world of the production cenX shape:
the card's output must equal the CPU's on a cut of that world, also
through the sweep's raw, table and split paths at small capacities; on
the cut and on the full world the card's edges must equal a numpy count
of sampled true k-mer pairs; the full world prints its sizes, the strips
of each sweep path, phase seconds and peak device memory.

    python3 chip_smoke.py

Each phase prints one JSON line with its seconds. Any failed check exits
non-zero. Needs CUDA: without a card it fails and prints no result. The
last line is {"ok": true, "device": {...}}.
"""

import json
import logging
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from centroflye_tpu_torch.config import (COVERAGE, KmerRecruitmentConfig,
                                         RecruitmentConfig)
from centroflye_tpu_torch.io.encoding import (decode, encode, kmer_codes,
                                              revcomp, string_to_kmer_code)
from centroflye_tpu_torch.io.fasta import iter_seqs, read_seq
from centroflye_tpu_torch.ops import _build
from centroflye_tpu_torch.ops.myers import build_peq, words_tensor
from centroflye_tpu_torch.ops.myers_cuda import (
    GROUPS, myers_hw_2strand, myers_hw_2strand_plain, myers_hw_v3,
    myers_hw_v3_banded, myers_hw_v3_plain, pick_group, threshold_hw)
from centroflye_tpu_torch.pipeline.cenx import run_unique_kmers
from centroflye_tpu_torch.pipeline.simulate import (add_read_noise,
                                                    gen_random_seq)
from centroflye_tpu_torch.stages.distance_graph import recruit_unique_kmers
from centroflye_tpu_torch.stages.unit_decomposition import (DecompRecord,
                                                            Decomposition)
from centroflye_tpu_torch.stages.recruitment import (RecruitmentEngine,
                                                     recruit_file,
                                                     segment_starts)

HERE = os.path.dirname(os.path.abspath(__file__))
UNIT_FASTA = os.path.join(HERE, "centroflye_tpu", "data", "DXZ1_rc.fasta")
N_READS = 8192            # the read mix of bench.py
CEN_FRACTION = 0.02
THRESHOLD = 350
BATCH_SIZE = 2048
SEG_LEN = 10240
K_BUDGET = 128            # rows K1 scores per fused step
CLI_READS = 300
PALLAS = "centroflye_tpu/ops/myers_pallas_v3.py"
K1_REPLACES = f"{PALLAS}:575"
K2_REPLACES = f"{PALLAS}:188"
K3_REPLACES = f"{PALLAS}:451"
CSRC = "centroflye_tpu_torch/csrc"
# bound: 32-bit integer operations per query word per text column (the
# add with its carry 2, d0 2, hp and hn 2, the two shifts 2, vp and vn 2,
# the Eq fetch 1), INT32 lanes per SM per clock, HBM bytes per second
OPS_PER_WORD_COLUMN = 11
INT32_LANES_PER_SM_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12
# stage 3's world: the shape of benchmarks/demo_cenx_production.py
# (production_1500u_c50_n5.json): DXZ1 units, their divergence, uniform
# read noise, read bases over the array; CUT_UNITS is the cut of the same
# world that the CPU runs too
WORLD_SEED = 7
N_UNITS = 1500
CUT_UNITS = 10
TRUTH_PAIRS = 4000        # true pairs truth_sample counts again
# the cut's clouds go through the sweep again at small capacities, on the
# card and the CPU: several raw strips, then coalesced table strips;
# table strips of many chunks (merge forests); strips sized past
# max_capacity, which split
CUT_SWEEPS = {"raw": dict(capacity=1 << 18),
              "table": dict(capacity=1 << 20, entry_chunk=1 << 16),
              "split": dict(capacity=1 << 18, dedup_hint=64,
                            max_capacity=1 << 18)}
DIV_RATE = 0.003
READ_NOISE = 0.055
READ_COVERAGE = 52
MIN_RECORD_LEN = 5000     # UnitDecompositionConfig.min_record_len


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel2_lengths(rng, n):
    """rel2-like lengths: ~88% regular long reads plus a 12% ultra-long
    component; overall mean ~14 kb (155 Gbp / 11.1 M reads)."""
    ul = rng.random(n) < 0.12
    lens = np.where(ul,
                    rng.lognormal(np.log(32_000), 0.45, n),
                    rng.lognormal(np.log(10_000), 0.5, n))
    return np.clip(lens, 500, 100_000).astype(np.int64)


def make_reads(unit: str, n_reads: int = N_READS):
    """bench.py's read mix from seed 0: 2% centromeric reads (tandem unit
    copies at 10% noise), the rest random sequence. Returns the reads and
    the ids of the centromeric ones."""
    rng = np.random.default_rng(0)
    lens = rel2_lengths(rng, n_reads)
    reads, cen = [], set()
    n_cen = max(1, int(n_reads * CEN_FRACTION))
    for i in range(n_reads):
        L = int(lens[i])
        if i % (n_reads // n_cen) == 0:
            n_copies = max(1, -(-L // len(unit)))
            seq = add_read_noise(rng, unit * n_copies, 0.10)[:L]
            cen.add(f"r{i:05d}")
        else:
            seq = gen_random_seq(rng, L)
        reads.append((f"r{i:05d}", seq))
    return reads, cen


def time_cuda(fn, reps):
    """Mean milliseconds of fn() over reps launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def k1_case(rng, unit_codes, m, L, B, dev):
    """Ragged 2-strand batch on the card: lens 0 and < m, N runs, tandem
    rows on both strands, random rows."""
    rc = revcomp(unit_codes)
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    reps = L // m + 1
    codes[0] = np.tile(unit_codes, reps)[:L]
    codes[1] = np.tile(rc, reps)[:L]
    for r in range(2, B, 16):           # noisy tandem rows, both strands
        src = unit_codes if r % 32 == 2 else rc
        row = np.tile(src, reps)[:L].copy()
        flip = rng.random(L) < 0.08
        row[flip] = rng.integers(0, 4, int(flip.sum()))
        codes[r] = row
    for r in range(3, B, 16):           # N runs
        s = int(rng.integers(0, L - 64))
        codes[r, s:s + 64] = 4
    codes[5] = 4                        # all N
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[:3] = L
    lens[6] = 0
    lens[7] = m // 2
    lens[8] = m - 1
    args = (words_tensor(build_peq(unit_codes), dev),
            words_tensor(build_peq(rc), dev),
            torch.from_numpy(codes.T.copy()).to(dev),
            torch.from_numpy(lens).to(dev))
    return args


def k3_case(rng, unit_codes, L, B, dev):
    """Rows whose distances straddle THRESHOLD, on both strands: tandem
    copies of the unit or its reverse complement with substitution and
    indel noise from 5% to 30%; 3000-6000 random bases, then tandem
    copies (row m-1 enters the band late); tandem, 3000 random bases,
    tandem (row m-1 leaves the band and comes back); random rows, N runs,
    and lens 0, m-1 and m/2."""
    m = len(unit_codes)
    srcs = [decode(unit_codes) * (L // m + 2),
            decode(revcomp(unit_codes)) * (L // m + 2)]
    codes = rng.integers(0, 4, (B, L)).astype(np.int8)
    lens = np.full(B, L, np.int32)
    for r in range(B):
        src = srcs[(r // 4) % 2]
        if r % 4 == 0:
            seq = add_read_noise(rng, src, float(rng.uniform(0.05, 0.30)))
        elif r % 4 == 1:
            seq = (gen_random_seq(rng, int(rng.integers(3000, 6000)))
                   + add_read_noise(rng, src, 0.05))
        elif r % 8 == 2:
            seq = (add_read_noise(rng, src[:m], 0.05)
                   + gen_random_seq(rng, 3000) + add_read_noise(rng, src, 0.05))
        else:
            continue
        codes[r] = encode(seq)[:L]
    for r in range(3, B, 8):            # N runs
        s = int(rng.integers(0, L - 200))
        codes[r, s:s + 200] = 4
    lens[B - 1] = 0
    lens[B - 2] = m - 1
    lens[B - 3] = m // 2
    return (words_tensor(build_peq(unit_codes), dev),
            words_tensor(build_peq(revcomp(unit_codes)), dev),
            torch.from_numpy(codes.T.copy()).to(dev),
            torch.from_numpy(lens).to(dev))


def int32_ops_per_s():
    """The card's INT32 rate at its maximum SM clock (nvidia-smi)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    mhz = float(smi.stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM_CLOCK * mhz * 1e6


def myers_bound(lens, words, strands, rate):
    """(bound_ms, bound_by) of HW Myers over a batch: `words` query words
    per column of each row's lens columns, per strand, against the bytes
    (one code per column, the lens, the peq tables, two int32 outputs per
    row and strand)."""
    n = int(lens.sum())
    ops = OPS_PER_WORD_COLUMN * words * n * strands
    nbytes = n + 4 * lens.numel() + strands * (5 * 4 * words
                                               + 8 * lens.numel())
    op_ms, byte_ms = ops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def max_abs_err(a, b):
    return max(int((a[k].cpu().long() - b[k].cpu().long()).abs().max())
               for k in a)


def timed_plain(fn):
    """(result, milliseconds) of a plain-version call on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_device():
    t0 = time.perf_counter()
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi_line, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0})
    return smi_line, kind


def phase_build():
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    with open(path + ".log") as f:
        regs = [ln.split(":", 1)[1].strip() for ln in f
                if "registers" in ln]
    emit({"phase": "build", "library": os.path.relpath(path, HERE),
          "ptxas": regs, "seconds": time.perf_counter() - t0})


def phase_k1(unit_codes, dev, rate):
    """K1 against its plain version on the card at the fused step's shape
    (k_budget rows of one segment), the wrapper's instance and every G,
    then a small case also against the plain version on the CPU."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    m = len(unit_codes)
    args = k1_case(rng, unit_codes, m, SEG_LEN, K_BUDGET, dev)
    pf, pr, text_t, lens = args
    got = myers_hw_2strand(*args, m=m)
    # the plain version, myers_hw_2strand_plain, is one myers_hw_v3_plain
    # call per strand: timed per strand, so that K2 has its own plain time
    want_f, plain_f_ms = timed_plain(
        lambda: myers_hw_v3_plain(pf, text_t, lens, m=m))
    want_r, plain_r_ms = timed_plain(
        lambda: myers_hw_v3_plain(pr, text_t, lens, m=m))
    plain_ms = plain_f_ms + plain_r_ms
    want = {"dist_f": want_f["dist"], "end_f": want_f["end"],
            "dist_r": want_r["dist"], "end_r": want_r["end"]}
    err = max_abs_err(got, want)
    check(int(got["dist_f"][0]) == 0 and int(got["dist_r"][1]) == 0,
          "tandem rows must align exactly")
    check((int(got["dist_f"][6]), int(got["end_f"][6])) == (m, -1),
          "a row of length 0 gives (m, -1)")
    k1_ms = time_cuda(lambda: myers_hw_2strand(*args, m=m), reps=20)
    by_group = {}
    for G in GROUPS:
        err = max(err, max_abs_err(myers_hw_2strand(*args, m=m, group=G),
                                   want))
        by_group[G] = time_cuda(
            lambda: myers_hw_2strand(*args, m=m, group=G), reps=20)
    check(err == 0, f"K1 != plain at {K_BUDGET}x{SEG_LEN}, m={m}")

    small_m = 90
    small = k1_case(rng, rng.integers(0, 4, small_m).astype(np.int8),
                    small_m, 256, 128, dev)
    want_s = myers_hw_2strand_plain(*small, m=small_m)
    cpu_s = myers_hw_2strand(*(a.cpu() for a in small), m=small_m)
    err_s = max_abs_err(want_s, cpu_s)
    for G in (None, *GROUPS):
        err_s = max(err_s, max_abs_err(
            myers_hw_2strand(*small, m=small_m, group=G), want_s))
    check(err_s == 0, "K1 != plain at m=90 (card or CPU)")
    bound_ms, bound_by = myers_bound(lens, pf.shape[1], 2, rate)
    group = pick_group(K_BUDGET, 2)
    emit({"phase": "k1", "shape": [K_BUDGET, SEG_LEN], "m": m,
          "max_abs_err": err, "k1_ms": k1_ms, "group": group,
          "ms_by_group": by_group, "bound_ms": bound_ms,
          "plain_ms": plain_ms, "small_m90_max_abs_err": err_s,
          "seconds": time.perf_counter() - t0})
    kernel = {"max_abs_err": max(err, err_s), "ms": k1_ms,
              "plain_ms": plain_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "library_ms": None,
              "instances": {f"{K_BUDGET}x{SEG_LEN}": {
                  "group": group, "ms": k1_ms, "bound_ms": bound_ms,
                  "ms_by_group": by_group}}}
    return kernel, {"args": args, "want": want, "plain_f_ms": plain_f_ms,
                    "small": small, "small_m": small_m}


def phase_k2(k1, k1_ms, m, rate):
    """K2 with peq_f, then peq_r, on phase k1's batch, the wrapper's
    instance and every G: each equals the matching strand of the plain
    result phase k1 computed. Then m = 90 against the plain version on
    the CPU."""
    t0 = time.perf_counter()
    pf, pr, text_t, lens = k1["args"]
    want = k1["want"]
    err = 0
    for G in (None, *GROUPS):
        for s, peq in (("f", pf), ("r", pr)):
            got = myers_hw_v3(peq, text_t, lens, m=m, group=G)
            err = max(err, max_abs_err(
                got, {"dist": want[f"dist_{s}"], "end": want[f"end_{s}"]}))
    check(err == 0, f"K2 != plain at {K_BUDGET}x{SEG_LEN}, m={m}")
    k2_ms = time_cuda(lambda: myers_hw_v3(pf, text_t, lens, m=m), reps=20)
    by_group = {G: time_cuda(lambda: myers_hw_v3(pf, text_t, lens, m=m,
                                                 group=G), reps=20)
                for G in GROUPS}

    small_m = k1["small_m"]
    spf, spr, stext, slens = k1["small"]
    err_s = 0
    for peq in (spf, spr):
        cpu = myers_hw_v3(peq.cpu(), stext.cpu(), slens.cpu(), m=small_m)
        for G in (None, *GROUPS):
            got = myers_hw_v3(peq, stext, slens, m=small_m, group=G)
            err_s = max(err_s, max_abs_err(got, cpu))
    check(err_s == 0, "K2 != CPU plain at m=90")
    bound_ms, bound_by = myers_bound(lens, pf.shape[1], 1, rate)
    group = pick_group(K_BUDGET, 1)
    emit({"phase": "k2", "shape": [K_BUDGET, SEG_LEN], "m": m,
          "max_abs_err": err, "k2_ms": k2_ms, "group": group,
          "ms_by_group": by_group, "bound_ms": bound_ms, "k1_ms": k1_ms,
          "plain_ms": k1["plain_f_ms"], "small_m90_max_abs_err": err_s,
          "seconds": time.perf_counter() - t0})
    return {"max_abs_err": max(err, err_s), "ms": k2_ms,
            "plain_ms": k1["plain_f_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "instances": {f"{K_BUDGET}x{SEG_LEN}": {
                "group": group, "ms": k2_ms, "bound_ms": bound_ms,
                "ms_by_group": by_group}}}


def k3_bound(lens, k, rate):
    """K3's bound: the query rows that every column's band must hold,
    the first k + 1 (a cell of row i <= k has a score <= k), as words;
    the rows a band holds beyond them near a match are not counted."""
    return myers_bound(lens, -(-(k + 1) // 32), 1, rate)


def phase_k3(unit_codes, dev, k1_ms, k2_ms, rate):
    """K3 at k = THRESHOLD against its plain version on its own
    128 x 10240 DXZ1 batch (one plain run per strand), then small cases
    at m = 90 (one band block), 300 and 1500 (two blocks), k in {0, 20,
    m}, against the plain version on the CPU."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    m = len(unit_codes)
    pf, pr, text_t, lens = k3_case(rng, unit_codes, SEG_LEN, K_BUDGET, dev)
    err, plain_ms, in_band = 0, [], []
    for peq in (pf, pr):
        got = myers_hw_v3_banded(peq, text_t, lens, m=m, k=THRESHOLD)
        want, ms = timed_plain(lambda: threshold_hw(
            myers_hw_v3_plain(peq, text_t, lens, m=m), m=m, k=THRESHOLD))
        err = max(err, max_abs_err(got, want))
        plain_ms.append(ms)
        in_band.append(int((got["dist"] <= THRESHOLD).sum()))
    check(err == 0, f"K3 != plain at {K_BUDGET}x{SEG_LEN}, k={THRESHOLD}")
    check(min(in_band) >= 8 and max(in_band) <= K_BUDGET - 8,
          f"K3 rows do not straddle k: {in_band} in band")
    k3_ms = time_cuda(lambda: myers_hw_v3_banded(pf, text_t, lens, m=m,
                                                 k=THRESHOLD), reps=20)
    k1_here = time_cuda(lambda: myers_hw_2strand(pf, pr, text_t, lens, m=m),
                        reps=20)
    k2_here = time_cuda(lambda: myers_hw_v3(pf, text_t, lens, m=m), reps=20)

    err_s = 0
    for small_m, L in ((90, 256), (300, 512), (1500, 3000)):
        codes = rng.integers(0, 4, small_m).astype(np.int8)
        args = k3_case(rng, codes, L, 128, dev)
        cpu_args = [a.cpu() for a in args]
        for peq, cpu_peq in ((args[0], cpu_args[0]), (args[1], cpu_args[1])):
            unbanded = myers_hw_v3_plain(cpu_peq, *cpu_args[2:], m=small_m)
            for k in (0, 20, small_m):
                got = myers_hw_v3_banded(peq, *args[2:], m=small_m, k=k)
                err_s = max(err_s, max_abs_err(
                    got, threshold_hw(unbanded, m=small_m, k=k)))
    check(err_s == 0, "K3 != CPU plain at m = 90, 300 or 1500")
    bound_ms, bound_by = k3_bound(lens, THRESHOLD, rate)
    emit({"phase": "k3", "shape": [K_BUDGET, SEG_LEN], "m": m,
          "k": THRESHOLD, "max_abs_err": err, "rows_in_band": in_band,
          "k3_ms": k3_ms, "bound_ms": bound_ms,
          "k2_ms_same_batch": k2_here,
          "k1_ms_same_batch": k1_here, "k2_ms_k1_batch": k2_ms,
          "k1_ms_k1_batch": k1_ms, "plain_ms": plain_ms,
          "small_max_abs_err": err_s, "seconds": time.perf_counter() - t0})
    return {"max_abs_err": max(err, err_s), "ms": k3_ms,
            "plain_ms": plain_ms[0], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_main_path(unit, dev):
    t0 = time.perf_counter()
    reads, cen = make_reads(unit)
    t_make = time.perf_counter() - t0
    total_bp = sum(len(s) for _, s in reads)
    cfg = RecruitmentConfig(threshold=THRESHOLD, batch_size=BATCH_SIZE)
    engine = RecruitmentEngine(unit, cfg, seg_len=SEG_LEN, device=dev)
    list(engine.run(reads[:272]))                 # warm-up
    torch.cuda.synchronize()

    myers_hw_2strand.launches = 0
    t_run = time.perf_counter()
    results = list(engine.run(reads))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t_run
    launches = myers_hw_2strand.launches

    check(launches > 0, "the main path launched K1 no time")
    check([r.r_id for r in results] == [r for r, _ in reads],
          "results out of input order")
    recruited = {r.r_id for r in results if r.recruited}
    missed = sorted(cen - recruited)
    extra = sorted(recruited - cen)
    check(not missed, f"centromeric reads not recruited: {missed[:10]}")
    check(not extra, f"background reads recruited: {extra[:10]}")

    t_exact = time.perf_counter()
    exact = RecruitmentEngine(
        unit, RecruitmentConfig(threshold=THRESHOLD, batch_size=BATCH_SIZE,
                                prefilter=False),
        seg_len=SEG_LEN, device=dev)
    batches = []                 # the exact tier's (codes, lens) batches
    score_batch = exact.distances

    def capture(codes, lens):
        batches.append((codes, lens.copy()))
        return score_batch(codes, lens)
    exact.distances = capture
    exact_set = {r.r_id for r in exact.run(reads) if r.recruited}
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t_exact
    check(exact_set == recruited,
          f"prefiltered != exact tier: {sorted(exact_set ^ recruited)[:10]}")
    emit({"phase": "main_path", "reads": len(reads), "mbp": total_bp / 1e6,
          "cen_reads": len(cen), "recruited": len(recruited),
          "exact_tier_reads": len(reads), "exact_tier_equal": True,
          "reads_per_s": len(reads) / dt, "mbp_per_s": total_bp / dt / 1e6,
          "run_seconds": dt, "k1_launches": launches,
          "make_reads_seconds": t_make, "exact_tier_seconds": exact_s,
          "seconds": time.perf_counter() - t0})
    return reads, recruited, launches, batches, exact.overlap


def phase_myers_ops(unit, reads, recruited, batches, overlap, dev, rate):
    """The Myers op library's HW entry points on the exact tier's
    batches of the main path's mix (BATCH_SIZE x SEG_LEN, both strands):
    K2 equals K1's strand, K3 at k = THRESHOLD equals K1's strand
    thresholded, and the reads K3 would recruit are the engine's. Then,
    with the counts read, the wrapper's K1 and K2 on batch 0 equal the
    plain version (one plain call per strand), every G instance of K1
    and K2 on every batch equals K1's strands, and each is timed on
    batch 0."""
    t0 = time.perf_counter()
    m = len(unit)
    uc = encode(unit)
    pf = words_tensor(build_peq(uc), dev)
    pr = words_tensor(build_peq(revcomp(uc)), dev)
    seg_read, seg_len = [], []    # exact-tier row -> read, segment length
    for i, (_, seq) in enumerate(reads):
        for st in segment_starts(len(seq), SEG_LEN, overlap):
            seg_read.append(i)
            seg_len.append(min(SEG_LEN, len(seq) - st))
    check(len(batches) == -(-len(seg_read) // BATCH_SIZE),
          "exact-tier batches do not cover the segments")
    read_min = np.full(len(reads), m, np.int64)
    in_band = 0

    myers_hw_v3.launches = 0
    myers_hw_v3_banded.launches = 0
    t_run = time.perf_counter()
    for b, (codes, lens) in enumerate(batches):
        rows = slice(b * BATCH_SIZE, (b + 1) * BATCH_SIZE)
        n = len(seg_read[rows])
        check(list(lens[:n]) == seg_len[rows] and not lens[n:].any(),
              f"exact-tier batch {b} is not the segments in read order")
        text_t = torch.from_numpy(codes).to(dev).t().contiguous()
        lens_t = torch.from_numpy(lens).to(dev)
        k1 = myers_hw_2strand(pf, pr, text_t, lens_t, m=m)
        dmin = None
        for s, peq in (("f", pf), ("r", pr)):
            one = {"dist": k1[f"dist_{s}"], "end": k1[f"end_{s}"]}
            k2 = myers_hw_v3(peq, text_t, lens_t, m=m)
            k3 = myers_hw_v3_banded(peq, text_t, lens_t, m=m, k=THRESHOLD)
            check(max_abs_err(k2, one) == 0, f"K2 != K1 ({s}), batch {b}")
            check(max_abs_err(k3, threshold_hw(one, m=m, k=THRESHOLD)) == 0,
                  f"K3 != K1 thresholded ({s}), batch {b}")
            d = k3["dist"][:n].cpu().numpy()
            dmin = d if dmin is None else np.minimum(dmin, d)
        in_band += int((dmin <= THRESHOLD).sum())
        np.minimum.at(read_min, seg_read[rows], dmin)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    launches = {"k2": myers_hw_v3.launches, "k3": myers_hw_v3_banded.launches}
    check(launches["k2"] > 0 and launches["k3"] > 0,
          f"the Myers op path launched K2 or K3 no time: {launches}")
    k3_set = {reads[i][0] for i in np.flatnonzero(read_min <= THRESHOLD)}
    check(k3_set == recruited,
          f"K3's recruited set != the engine's: {sorted(k3_set ^ recruited)[:10]}")

    text0 = torch.from_numpy(batches[0][0]).to(dev).t().contiguous()
    lens0 = torch.from_numpy(batches[0][1]).to(dev)
    k1 = myers_hw_2strand(pf, pr, text0, lens0, m=m)
    plain_ms, plain_err, plain_in_band = {}, 0, 0
    for s, peq in (("f", pf), ("r", pr)):
        want, plain_ms[s] = timed_plain(
            lambda: myers_hw_v3_plain(peq, text0, lens0, m=m))
        plain_err = max(
            plain_err,
            max_abs_err({"dist": k1[f"dist_{s}"], "end": k1[f"end_{s}"]},
                        want),
            max_abs_err(myers_hw_v3(peq, text0, lens0, m=m), want))
        plain_in_band += int((want["dist"] <= THRESHOLD).sum())
    check(plain_err == 0, "K1 or K2 != plain on exact-tier batch 0")
    check(plain_in_band > 0, "exact-tier batch 0 holds no row within k")

    err = 0
    for codes, lens in batches:
        text_t = torch.from_numpy(codes).to(dev).t().contiguous()
        lens_t = torch.from_numpy(lens).to(dev)
        k1 = myers_hw_2strand(pf, pr, text_t, lens_t, m=m)
        for G in GROUPS:
            err = max(err, max_abs_err(
                myers_hw_2strand(pf, pr, text_t, lens_t, m=m, group=G), k1))
            for s, peq in (("f", pf), ("r", pr)):
                err = max(err, max_abs_err(
                    myers_hw_v3(peq, text_t, lens_t, m=m, group=G),
                    {"dist": k1[f"dist_{s}"], "end": k1[f"end_{s}"]}))
    check(err == 0, "a G instance of K1 or K2 != K1 on an exact-tier batch")

    ms = {"k1_ms": time_cuda(lambda: myers_hw_2strand(pf, pr, text0, lens0,
                                                      m=m), reps=5),
          "k2_ms": time_cuda(lambda: myers_hw_v3(pf, text0, lens0, m=m),
                             reps=5),
          "k3_ms": time_cuda(lambda: myers_hw_v3_banded(
              pf, text0, lens0, m=m, k=THRESHOLD), reps=5)}
    by_group = {f"k{k}": {G: time_cuda(lambda: fn(G), reps=5)
                          for G in GROUPS}
                for k, fn in (
                    (1, lambda G: myers_hw_2strand(pf, pr, text0, lens0,
                                                   m=m, group=G)),
                    (2, lambda G: myers_hw_v3(pf, text0, lens0, m=m,
                                              group=G)))}
    W = pf.shape[1]
    bounds = {"k1": myers_bound(lens0, W, 2, rate)[0],
              "k2": myers_bound(lens0, W, 1, rate)[0],
              "k3": k3_bound(lens0, THRESHOLD, rate)[0]}
    groups = {"k1": pick_group(BATCH_SIZE, 2), "k2": pick_group(BATCH_SIZE, 1)}
    emit({"phase": "myers_ops", "batches": len(batches),
          "segments": len(seg_read), "shape": [BATCH_SIZE, SEG_LEN],
          "k": THRESHOLD, "segments_in_band": in_band,
          "recruited": len(k3_set), "k3_set_equal": True,
          "batch0_vs_plain_max_abs_err": plain_err,
          "batch0_rows_in_band_vs_plain": plain_in_band,
          "plain_ms_batch0": plain_ms, "instances_max_abs_err": err,
          "launches": launches, "run_seconds": run_s,
          "ms_at_2048_rows_batch0": ms, "ms_by_group_batch0": by_group,
          "bound_ms_batch0": bounds, "group": groups,
          "batch0_sum_lens": int(lens0.sum()),
          "seconds": time.perf_counter() - t0})
    shape = f"{BATCH_SIZE}x{SEG_LEN}"
    plain = {"k1": plain_ms["f"] + plain_ms["r"], "k2": plain_ms["f"]}
    instances = {k: {shape: {"group": groups[k], "ms": ms[f"{k}_ms"],
                             "plain_ms": plain[k], "bound_ms": bounds[k],
                             "ms_by_group": by_group[k]}}
                 for k in ("k1", "k2")}
    instances["k3"] = {shape: {"ms": ms["k3_ms"], "bound_ms": bounds["k3"]}}
    return launches, instances


def phase_cli(reads, recruited, dev):
    t0 = time.perf_counter()
    sub = reads[:CLI_READS]
    want = [(r_id, seq) for r_id, seq in sub if r_id in recruited]
    check(want, "the CLI slice holds no recruited read")
    with tempfile.TemporaryDirectory() as tmp:
        reads_fn = os.path.join(tmp, "reads.fasta")
        out_fn = os.path.join(tmp, "recruited.fasta")
        with open(reads_fn, "w") as f:
            for r_id, seq in sub:
                f.write(f">{r_id}\n{seq}\n")
        n = recruit_file(UNIT_FASTA, reads_fn, out_fn, THRESHOLD,
                         batch_size=BATCH_SIZE, seg_len=SEG_LEN,
                         device=dev)
        got = list(iter_seqs(out_fn))
    check(n == len(want) and got == want,
          f"CLI output {[r for r, _ in got]} != {[r for r, _ in want]}")
    emit({"phase": "cli", "reads": len(sub), "recruited": n,
          "seconds": time.perf_counter() - t0})


def rel2_length_mix(rng, n):
    """The read lengths of benchmarks/demo_cenx_production.py: 25% around
    75 kb, 75% around 11 kb, clipped to 3-200 kb."""
    ul = rng.random(n) < 0.25
    lens = np.where(ul, rng.lognormal(np.log(75_000), 0.35, n),
                    rng.lognormal(np.log(11_000), 0.6, n))
    return np.clip(lens, 3_000, 200_000).astype(np.int64)


def make_world(unit, n_units, seed=WORLD_SEED):
    """Stage 3's input, in bulk numpy: a tandem array of n_units copies
    of `unit` with DIV_RATE substitutions, reads of the rel2 mix at
    READ_COVERAGE x over it with uniform READ_NOISE (deletion, insertion
    before the base, substitution: a third each), and the decomposition
    records that stand in for stage 2: each read's whole units, strand
    +, bounds at the simulated unit boundaries carried through the noise.
    Returns (array codes, Decomposition, read count, read bases)."""
    rng = np.random.default_rng(seed)
    m = len(unit)
    arr = np.tile(encode(unit), n_units)
    n_mut = int(rng.binomial(arr.size, DIV_RATE))
    pos = rng.choice(arr.size, n_mut, replace=False)
    arr[pos] = (arr[pos] + rng.integers(1, 4, n_mut)) % 4
    lens = rel2_length_mix(rng, int(READ_COVERAGE * arr.size / 3_000))
    lens = np.minimum(lens, arr.size)
    n_reads = int(np.searchsorted(np.cumsum(lens),
                                  READ_COVERAGE * arr.size)) + 1
    lens = lens[:n_reads]
    starts = rng.integers(0, arr.size - lens + 1)
    u0 = -(-starts // m)                       # first whole unit
    nu = (starts + lens) // m - u0             # whole units in the read
    keep = nu * m >= MIN_RECORD_LEN
    u0, nu = u0[keep], nu[keep]
    # the records' bases, concatenated, with the noise applied in bulk
    src = np.concatenate([arr[a * m:(a + n) * m] for a, n in zip(u0, nu)])
    r = rng.random(src.size)
    third = READ_NOISE / 3
    dele, ins = r < third, (r >= third) & (r < 2 * third)
    sub = (r >= 2 * third) & (r < READ_NOISE)
    src[sub] = (src[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    emit = np.where(dele, 0, np.where(ins, 2, 1))
    cum = np.concatenate([[0], np.cumsum(emit)])
    out = np.empty(int(cum[-1]), np.int8)
    out[cum[:-1][~dele] + ins[~dele]] = src[~dele]
    out[cum[:-1][ins]] = rng.integers(0, 4, int(ins.sum()))
    records, g0 = {}, 0
    for i, n in enumerate(nu):
        b = cum[g0 + np.arange(n + 1) * m]
        seq = decode(out[b[0]:b[-1]])
        r_id = f"w{i:05d}"
        records[r_id] = DecompRecord(r_id, len(seq), "+", 0, len(seq), seq,
                                     (b - b[0]).astype(np.int32))
        g0 += n * m
    dec = Decomposition(records, {r: [(0, rec.r_len, "+")]
                                  for r, rec in records.items()},
                        {r: rec.r_len for r, rec in records.items()}, [])
    return arr, dec, n_reads, int(lens.sum())


class PhaseLog(logging.Handler):
    """Sums the `seconds` and `counts` that the port's stage-3 modules
    log with their phase records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.sums = {}

    def emit(self, record):
        for key in ("seconds", "counts"):
            for k, v in getattr(record, key, {}).items():
                self.sums[k] = self.sums.get(k, 0) + v


def read_artifacts(outdir, c):
    out = []
    for name in (f"unique_kmers_min_edge_cov_{c}.txt",
                 f"unique_edges_min_edge_cov_{c}.txt"):
        with open(os.path.join(outdir, "recruited_unique_kmers", name),
                  "rb") as f:
            out.append(f.read())
    return out


def truth_sample(arr, m, cfg, res, n_pairs=TRUTH_PAIRS):
    """Stage 3's edges against an independent count on a sample of true
    unit-to-unit k-mer pairs: (i, j) with both k-mers once in the
    simulated array and rare, i in array unit u and j in unit u + 1. Per
    pair, numpy counts from the clouds the sweep ran on how often j sits
    d units after i in one record, for every d <= max_distance; the edge
    (i, j, 1) must be in the result, with that count, exactly when the
    rule keeps it (count >= min_coverage and count / all distances >=
    rel_threshold). Also the share of unique k-mers once in the array."""
    codes, valid = kmer_codes(arr, cfg.k)
    u, first, cnt = np.unique(codes[valid], return_index=True,
                              return_counts=True)
    once, once_pos = u[cnt == 1], np.flatnonzero(valid)[first][cnt == 1]
    in_rare = np.isin(once, res.rare)
    tensor = res.clouds
    check(tensor.shape[1] < 1000, "truth sample: a record of 1000 units")
    # each rare k-mer's (record, unit instance) occurrences, as r * 1000 + t
    r, t, _ = np.nonzero(tensor >= 0)
    vals = tensor[tensor >= 0]
    order = np.argsort(vals, kind="stable")
    occ_keys = (r.astype(np.int64) * 1000 + t)[order]
    bounds = np.searchsorted(vals[order], np.arange(len(res.rare) + 1))
    by_unit = {}
    for i, uu in zip(np.searchsorted(res.rare, once[in_rare]),
                     once_pos[in_rare] // m):
        by_unit.setdefault(int(uu), []).append(int(i))
    cand = [(i, j) for uu in sorted(by_unit) if uu + 1 in by_unit
            for i in by_unit[uu] for j in by_unit[uu + 1]]
    pick = np.random.default_rng(0).choice(
        len(cand), min(n_pairs, len(cand)), replace=False)
    e = res.edges
    got = {(i, j): f for i, j, d, f in zip(e.i.tolist(), e.j.tolist(),
                                           e.dist.tolist(), e.freq.tolist())
           if d == 1}
    counts, want, bad = [], 0, []
    for i, j in (cand[p] for p in pick):
        a = occ_keys[bounds[i]:bounds[i + 1]]
        b = occ_keys[bounds[j]:bounds[j + 1]]
        diff = b[None, :] - a[:, None]
        same = (b[None, :] // 1000) == (a[:, None] // 1000)
        d = diff[same & (diff >= cfg.min_distance)
                 & (diff <= cfg.max_distance)]
        by_d = np.bincount(d, minlength=2)
        c1, total = int(by_d[1]), int(by_d.sum())
        counts.append(c1)
        keep = c1 >= cfg.min_coverage and c1 >= cfg.rel_threshold * total
        want += keep
        if (got.get((i, j)) == c1) != keep or (not keep and (i, j) in got):
            bad.append((i, j, c1, total, got.get((i, j))))
    out = {"once_in_array": len(once), "once_and_rare": int(in_rare.sum()),
           "pairs": len(pick), "edges_by_rule": want, "differ": len(bad),
           "count_hist": np.bincount(np.minimum(counts, 12),
                                     minlength=13).tolist(),
           "examples": bad[:5],
           "unique_once_in_array": float(np.isin(res.codes, once).mean())}
    check(len(pick) > 0 and want > 0 and not bad,
          f"truth sample: the edges differ from the count: {out}")
    return out


def phase_unique_kmers(unit, dev):
    """Stage 3 (rare k-mers, then the distance-graph unique k-mers) through
    `run_unique_kmers`. First the cut world on the card and on the CPU:
    the rare codes, the unique codes and the edges (i, j, d, freq; the
    edge file) must be identical. Then the full world on the card. Both
    print their sizes and the strips each sweep path took, and both hold
    the card's edges against `truth_sample`; the full world also prints
    its phase seconds and peak device memory."""
    t0 = time.perf_counter()
    cfg = KmerRecruitmentConfig()
    log = PhaseLog()
    logger = logging.getLogger("centroflye_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(log)

    def run(dec, d, outdir):
        log.sums.clear()
        t = time.perf_counter()
        res = run_unique_kmers(dec, cfg, COVERAGE, outdir, device=d)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, dict(log.sums)

    def sizes(res, sums):
        check(len(res.codes) > 0 and np.isin(res.codes, res.rare).all(),
              "no unique k-mer, or one that is not rare")
        return {"rare_kmers": len(res.rare), "unique_kmers": len(res.codes),
                "edges": len(res.edges.i),
                "pair_observations": sums["pair_obs"],
                **{k: sums.get(k, 0) for k in (
                    "strips", "raw_strips", "table_strips",
                    "host_planned_strips", "strip_splits",
                    "strips_coalesced")}}

    cut_arr, cut_dec, cut_reads, _ = make_world(unit, CUT_UNITS)
    cut = {"units": CUT_UNITS, "reads": cut_reads}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for where, d in (("cpu", "cpu"), ("card", dev)):
            out = os.path.join(tmp, where)
            res, secs, sums = run(cut_dec, d, out)
            runs[where] = res, read_artifacts(out, cfg.min_coverage), sums
            cut[f"{where}_seconds"] = secs
    (cpu, cpu_files, _), (card, card_files, sums) = runs["cpu"], runs["card"]
    check(np.array_equal(cpu.rare, card.rare),
          "cut world: rare k-mers on the card != on the CPU")
    check(cpu_files == card_files,
          "cut world: unique k-mers or edges on the card != on the CPU")
    cut.update(sizes(card, sums), identical=True,
               truth=truth_sample(cut_arr, len(unit), cfg, card))
    # the sweep's other paths on the cut's clouds, the card against the
    # CPU and against the run above
    cut["sweeps"] = {}
    for name, kw in CUT_SWEEPS.items():
        got, secs = [], {}
        for where, d in (("cpu", "cpu"), ("card", dev)):
            log.sums.clear()
            t = time.perf_counter()
            got.append(recruit_unique_kmers(
                card.clouds, card.n_units, card.rare, cfg, device=d, **kw))
            secs[f"{where}_seconds"] = time.perf_counter() - t
        for codes, e in got:
            check(np.array_equal(codes, card.codes) and all(
                np.array_equal(getattr(e, f), getattr(card.edges, f))
                for f in ("i", "j", "dist", "freq")),
                f"cut world, sweep {name}: the card or the CPU differs")
        cut["sweeps"][name] = {k: log.sums.get(k, 0) for k in (
            "strips", "raw_strips", "table_strips", "strip_splits",
            "strips_coalesced")} | secs
    del runs, cpu, card

    t = time.perf_counter()
    arr, dec, n_reads, read_bp = make_world(unit, N_UNITS)
    world_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        res, run_s, sums = run(dec, dev, tmp)
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(tmp, "recruited_unique_kmers",
                               f"unique_kmers_min_edge_cov_"
                               f"{cfg.min_coverage}.txt")) as f:
            from_file = [string_to_kmer_code(ln.strip()) for ln in f]
    logger.removeHandler(log)
    check(from_file == res.codes.tolist(),
          "full world: the k-mer artifact differs from the result")
    t = time.perf_counter()
    truth = truth_sample(arr, len(unit), cfg, res)
    truth_s = time.perf_counter() - t
    seconds = {k: sums[k] for k in (
        "rare", "rare_occ", "rare_count_merge", "rare_readback", "clouds",
        "sweep", "sweep_plan", "artifacts")}
    seconds["sweep_device"] = sums["sweep"] - sums["sweep_plan"]
    emit({"phase": "unique_kmers", "units": N_UNITS,
          "div_rate": DIV_RATE, "noise": READ_NOISE,
          "coverage_config": COVERAGE, "reads": n_reads,
          "records": len(dec.records), "mbp": read_bp / 1e6,
          "record_mbp": sum(r.r_len for r in dec.records.values()) / 1e6,
          "read_coverage": read_bp / arr.size, **sizes(res, sums),
          "unique_once_in_array": truth.pop("unique_once_in_array"),
          "truth": truth, "truth_seconds": truth_s,
          "world_seconds": world_s, "run_seconds": run_s,
          "phase_seconds": seconds, "max_memory_allocated": peak,
          "cut_world": cut, "seconds": time.perf_counter() - t0})


def main():
    smi_line, kind = phase_device()
    dev = torch.device("cuda")
    rate = int32_ops_per_s()
    phase_build()
    unit = read_seq(UNIT_FASTA)
    m = len(unit)
    k1, k1_state = phase_k1(encode(unit), dev, rate)
    k2 = phase_k2(k1_state, k1["ms"], m, rate)
    k3 = phase_k3(encode(unit), dev, k1["ms"], k2["ms"], rate)
    reads, recruited, launches, batches, overlap = phase_main_path(unit, dev)
    phase_cli(reads, recruited, dev)
    ops_launches, at_2048 = phase_myers_ops(unit, reads, recruited, batches,
                                            overlap, dev, rate)
    phase_unique_kmers(unit, dev)
    for kernel, key in ((k1, "k1"), (k2, "k2"), (k3, "k3")):
        kernel.setdefault("instances", {}).update(at_2048[key])
    emit({"kernels": [
        {"name": "myers_hw_2strand", "route": "cuda",
         "source": f"{CSRC}/myers_hw_2strand.cu", "replaces": K1_REPLACES,
         "launches": launches, **k1},
        {"name": "myers_hw_v3", "route": "cuda",
         "source": f"{CSRC}/myers_hw_2strand.cu", "replaces": K2_REPLACES,
         "launches": ops_launches["k2"], **k2},
        {"name": "myers_hw_v3_banded", "route": "cuda",
         "source": f"{CSRC}/myers_hw_banded.cu", "replaces": K3_REPLACES,
         "launches": ops_launches["k3"], **k3}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
