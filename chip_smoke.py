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
clock and its bytes over the memory rate.

Then stages 2-4 of cenX on a simulated world of the production cenX
shape (make_world: a 1,500-unit DXZ1 array, reads at 52x, and 24 prefix
and 24 suffix reads with 52-90 kb of flank). Phase decomposition builds
the port's native Myers library (g++) and runs the unit decomposer on
the host: the boundary reads must classify as 24 prefix and 24 suffix
reads, and a sample of the world's records is held against its true
bounds. Phase unique_kmers drives stage 3 (rare k-mers, then the
distance-graph unique k-mers, through pipeline/cenx.run_unique_kmers;
plain PyTorch on the card, no kernel of its own): the card's output must
equal the CPU's on a cut of that world, also through the sweep's raw,
table and split paths at small capacities; on the cut and on the full
world the card's edges must equal a numpy count of sampled true k-mer
pairs; the full world prints its sizes, the strips of each sweep path,
phase seconds and peak device memory. Phase placement drives stage 4
(run_placement, its bulk scoring on the card, then
run_placement_validation) on the full world with stage 3's unique
k-mers: every bulk-scoring call must equal the other scorer on the card
(and the CPU on the first), read_positions.csv must be the JAX
package's (its digest, tools/placement_vs_jax.py), and the placed reads
must sit at their true unit and re-map there.

    python3 chip_smoke.py

Each phase prints one JSON line with its seconds. Any failed check exits
non-zero. Needs CUDA: without a card it fails and prints no result. The
last line is {"ok": true, "device": {...}}."""

import collections
import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from centroflye_tpu_torch import native
from centroflye_tpu_torch.config import (COVERAGE, KmerRecruitmentConfig,
                                         PlacerConfig, RecruitmentConfig,
                                         UnitDecompositionConfig)
from centroflye_tpu_torch.io.encoding import (decode, encode, kmer_codes,
                                              revcomp, string_to_kmer_code)
from centroflye_tpu_torch.io.fasta import iter_seqs, read_seq
from centroflye_tpu_torch.ops import _build, scoring
from centroflye_tpu_torch.ops.myers import build_peq, words_tensor
from centroflye_tpu_torch.ops.myers_cuda import (
    GROUPS, myers_hw_2strand, myers_hw_2strand_plain, myers_hw_v3,
    myers_hw_v3_banded, myers_hw_v3_plain, pick_group, threshold_hw)
from centroflye_tpu_torch.pipeline.cenx import (run_placement,
                                                run_placement_validation,
                                                run_unique_kmers)
from centroflye_tpu_torch.pipeline.simulate import (add_read_noise,
                                                    gen_random_seq)
from centroflye_tpu_torch.stages.distance_graph import recruit_unique_kmers
from centroflye_tpu_torch.stages.read_placer import read_positions_file
from centroflye_tpu_torch.stages.unit_decomposition import (DecompRecord,
                                                            Decomposition,
                                                            UnitDecomposer)
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
BOUNDARY_READS = 24       # prefix reads, and as many suffix reads
FLANK_BP = 200_000        # each end's flank (the JAX demo's)
# sha256 of read_positions.csv as the JAX package's ReadPlacer writes it
# for the full world's records and unique k-mers (CPU, on the card's
# machine): `JAX_PLATFORMS=cpu python3 tools/placement_vs_jax.py`
PLACEMENT_DIGEST = (
    "23748246ac3eb7c76415a459e7fb08a13b7a5c2b6b902af2553e197c5f211841")
DECOMP_SAMPLE = 500       # world records decomposed again in stage 2


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


def add_noise(rng, src):
    """Uniform READ_NOISE on a code array, in bulk: deletion, insertion
    before the base, substitution, a third each. Returns the noisy codes
    and `cum`, where cum[i] is where source base i's span (an insertion
    before it, then the base) starts in the output and cum[-1] is the
    output's length."""
    src = src.copy()
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
    return out, cum


@dataclasses.dataclass
class World:
    """The simulated cenX world of `make_world`."""

    arr: np.ndarray           # the tandem array's codes
    unit_len: int
    dec: Decomposition        # the records standing in for stage 2
    n_reads: int              # reads over the array, records or not
    read_bp: int
    u0: dict                  # record or boundary read -> its first unit
    # the reads over the array's ends: (r_id, seq), and each read's true
    # whole-unit boundaries in its coordinates
    boundary: list
    boundary_bounds: dict


def make_world(unit, n_units, seed=WORLD_SEED):
    """Stages 2-4's input, in bulk numpy: a tandem array of n_units
    copies of `unit` with DIV_RATE substitutions, reads of the rel2 mix
    at READ_COVERAGE x over it with uniform READ_NOISE (`add_noise`), and
    the decomposition records that stand in for stage 2: each read's
    whole units, strand +, bounds at the simulated unit boundaries
    carried through the noise. Then, from a second generator (seed + 1,
    so the records above do not move), the reads over the array's ends
    that benchmarks/demo_cenx_production.py's flanked genome has: a
    random FLANK_BP flank at each end; BOUNDARY_READS prefix and as many
    suffix reads shaped as its extra ones, 52-90 kb of flank before
    (after) 4-10 whole units at the array's start (end); and the
    rel2-mix reads at READ_COVERAGE that cross an end from its flank
    with MIN_RECORD_LEN of whole units (ids lft*, rgt*), all with the
    same noise. Only the decomposer turns these into records."""
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
    out, cum = add_noise(rng, np.concatenate(
        [arr[a * m:(a + n) * m] for a, n in zip(u0, nu)]))
    records, first, g0 = {}, {}, 0
    for i, (a, n) in enumerate(zip(u0, nu)):
        b = cum[g0 + np.arange(n + 1) * m]
        seq = decode(out[b[0]:b[-1]])
        r_id = f"w{i:05d}"
        records[r_id] = DecompRecord(r_id, len(seq), "+", 0, len(seq), seq,
                                     (b - b[0]).astype(np.int32))
        first[r_id] = int(a)
        g0 += n * m
    dec = Decomposition(records, {r: [(0, rec.r_len, "+")]
                                  for r, rec in records.items()},
                        {r: rec.r_len for r, rec in records.items()}, [])
    rng = np.random.default_rng(seed + 1)
    left, right = (rng.integers(0, 4, FLANK_BP).astype(np.int8)
                   for _ in range(2))
    # (r_id, source codes, where its first whole unit starts, whole units,
    # the first whole unit's index in the array)
    reads = []
    for kind in ("pre", "suf"):
        for j in range(BOUNDARY_READS):
            f = int(rng.integers(52_000, 90_000))
            into = int(rng.integers(4, 10))
            if kind == "pre":
                reads.append((f"pre{j:02d}", np.concatenate(
                    [left[FLANK_BP - f:], arr[:into * m]]), f, into, 0))
            else:
                reads.append((f"suf{j:02d}", np.concatenate(
                    [arr[arr.size - into * m:], right[:f]]), 0, into,
                    n_units - into))
    # the rel2-mix reads at READ_COVERAGE that cross an end of the array
    # from a FLANK_BP flank, as the JAX demo's reads over its flanked
    # genome do: from each side, reads starting (ending) uniformly in the
    # flank, kept if they hold MIN_RECORD_LEN of whole units
    for kind in ("lft", "rgt"):
        side = rel2_length_mix(rng, int(READ_COVERAGE * FLANK_BP / 3_000))
        side = side[:int(np.searchsorted(np.cumsum(side),
                                         READ_COVERAGE * FLANK_BP)) + 1]
        f = rng.integers(1, FLANK_BP + 1, side.size)   # flank bases held
        inside = np.minimum(side - f, arr.size)
        for j in np.flatnonzero(inside // m * m >= MIN_RECORD_LEN):
            fj, ij = int(f[j]), int(inside[j])
            if kind == "lft":
                reads.append((f"lft{j:03d}", np.concatenate(
                    [left[FLANK_BP - fj:], arr[:ij]]), fj, ij // m, 0))
            else:
                a = -(-(arr.size - ij) // m)
                reads.append((f"rgt{j:03d}", np.concatenate(
                    [arr[arr.size - ij:], right[:fj]]),
                    a * m - (arr.size - ij), n_units - a, a))
    boundary, true_bounds = [], {}
    for r_id, src, at, nu, a in reads:
        noisy, cum = add_noise(rng, src)
        boundary.append((r_id, decode(noisy)))
        true_bounds[r_id] = cum[at + np.arange(nu + 1) * m]
        first[r_id] = a
    return World(arr, m, dec, n_reads, int(lens.sum()), first, boundary,
                 true_bounds)


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
    once, once_pos = once_in_array(arr, cfg.k)
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
           "count_hist": np.bincount(np.minimum(np.asarray(counts, int),
                                                12), minlength=13).tolist(),
           "examples": bad[:5],
           "unique_once_in_array": float(np.isin(res.codes, once).mean())}
    check(len(pick) > 0 and want > 0 and not bad,
          f"truth sample: the edges differ from the count: {out}")
    return out


def merge_decompositions(a, b):
    return Decomposition({**a.records, **b.records},
                         {**a.positions_all, **b.positions_all},
                         {**a.read_lens, **b.read_lens},
                         a.discarded + b.discarded)


def phase_unique_kmers(unit, dev, world, world_s, boundary_dec):
    """Stage 3 (rare k-mers, then the distance-graph unique k-mers) through
    `run_unique_kmers`. First the cut world (its records only) on the
    card and on the CPU: the rare codes, the unique codes and the edges
    (i, j, d, freq; the edge file) must be identical. Then the full
    world's records with the decomposed boundary reads' on the card.
    Both print their sizes and the strips each sweep path took, and both
    hold the card's edges against `truth_sample`; the full world also
    prints its phase seconds and peak device memory. Returns the full
    world's result and its Decomposition, for phase placement."""
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

    cut_world = make_world(unit, CUT_UNITS)
    cut_arr, cut_dec = cut_world.arr, cut_world.dec
    cut = {"units": CUT_UNITS, "reads": cut_world.n_reads}
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

    arr, read_bp = world.arr, world.read_bp
    dec = merge_decompositions(world.dec, boundary_dec)
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
          "coverage_config": COVERAGE, "reads": world.n_reads,
          "records": len(dec.records),
          "boundary_records": len(boundary_dec.records),
          "mbp": read_bp / 1e6,
          "record_mbp": sum(r.r_len for r in dec.records.values()) / 1e6,
          "read_coverage": read_bp / arr.size, **sizes(res, sums),
          "unique_once_in_array": truth.pop("unique_once_in_array"),
          "truth": truth, "truth_seconds": truth_s,
          "world_seconds": world_s, "run_seconds": run_s,
          "phase_seconds": seconds, "max_memory_allocated": peak,
          "cut_world": cut, "seconds": time.perf_counter() - t0})
    return res, dec


def bound_errors(dec, truth):
    """Records of `dec` against true unit boundaries (r_id -> boundary
    positions in the read): how many reads gave a record, how many on
    strand + with the true unit count, and over those the median and
    largest |boundary - true boundary| in bp."""
    found = [r for r in truth if r in dec.records]
    right = [r for r in found if dec.records[r].strand == "+"
             and dec.records[r].n_units == len(truth[r]) - 1]
    err = np.concatenate([np.abs(dec.records[r].bounds.astype(np.int64)
                                 + dec.records[r].r_st - truth[r])
                          for r in right] or [np.zeros(0, np.int64)])
    return {"reads": len(truth), "records": len(found),
            "true_unit_count": len(right),
            "bound_err_median_bp": float(np.median(err)) if err.size else None,
            "bound_err_max_bp": int(err.max()) if err.size else None}


def phase_decomposition(unit, world):
    """Stage 2 on the host: the port's native Myers library builds (g++)
    and loads; `UnitDecomposer` turns the reads over the array's ends
    into records (the 24 shaped prefix and 24 suffix reads must classify
    so, and the flank-crossing reads are counted against the class
    their flank gives), and decomposes a seeded sample of DECOMP_SAMPLE
    of the world's records; each set is held against the true bounds
    `make_world` knows. Returns the boundary reads' Decomposition."""
    t0 = time.perf_counter()
    lib = native.build()
    native.load_library()
    build_s = time.perf_counter() - t0
    decomposer = UnitDecomposer(unit, UnitDecompositionConfig())
    t = time.perf_counter()
    bdec = decomposer.decompose(world.boundary)
    boundary_s = time.perf_counter() - t
    pcfg = PlacerConfig()
    classes = bdec.classify(pcfg.prefix_threshold, pcfg.small_threshold)
    got = {r: name for name, ids in zip(("prefix", "internal", "suffix"),
                                        classes) for r in ids}
    seqs = dict(world.boundary)
    shaped = [r for r in seqs if r[:3] in ("pre", "suf")]
    crossing = [r for r in seqs if r not in shaped]

    def flank_class(r):
        b = world.boundary_bounds[r]
        if r.startswith("lft") and b[0] > pcfg.prefix_threshold:
            return "prefix"
        if r.startswith("rgt") and \
                len(seqs[r]) - b[-1] > pcfg.prefix_threshold:
            return "suffix"
        return "internal"

    def stats(ids):
        truth = {r: world.boundary_bounds[r] for r in ids}
        mbp = sum(len(seqs[r]) for r in ids) / 1e6
        return {**bound_errors(bdec, truth), "mbp": mbp,
                **{name: sum(got.get(r) == name for r in ids)
                   for name in ("prefix", "internal", "suffix")}}

    ids = sorted(world.dec.records)
    pick = np.random.default_rng(WORLD_SEED).choice(
        len(ids), min(DECOMP_SAMPLE, len(ids)), replace=False)
    sample = [(ids[i], world.dec.records[ids[i]].seq) for i in sorted(pick)]
    t = time.perf_counter()
    sdec = decomposer.decompose(sample)
    sample_s = time.perf_counter() - t
    s_err = bound_errors(sdec, {r: world.dec.records[r].bounds
                                for r, _ in sample})
    s_mbp = sum(len(seq) for _, seq in sample) / 1e6
    b_mbp = sum(len(seq) for seq in seqs.values()) / 1e6
    emit({"phase": "decomposition", "library": os.path.relpath(lib, HERE),
          "build_seconds": build_s,
          "boundary": {"mbp": b_mbp, "seconds": boundary_s,
                       "mbp_per_s": b_mbp / boundary_s,
                       "shaped": stats(shaped),
                       "flank_crossing": {
                           **stats(crossing),
                           "class_as_flank": sum(got.get(r) == flank_class(r)
                                                 for r in crossing),
                           "by_flank": collections.Counter(
                               map(flank_class, crossing))}},
          "sample": {**s_err, "mbp": s_mbp, "seconds": sample_s,
                     "mbp_per_s": s_mbp / sample_s},
          "seconds": time.perf_counter() - t0})
    want = {r: "prefix" if r.startswith("pre") else "suffix" for r in shaped}
    check({r: got.get(r) for r in shaped} == want,
          f"shaped boundary reads: classify gave "
          f"{collections.Counter(got.get(r) for r in shaped)}")
    check(sum(got.get(r) == flank_class(r) for r in crossing)
          >= 0.95 * len(crossing), "flank-crossing reads: classify "
          "disagrees with their flanks")
    check(s_err["records"] >= 0.95 * len(sample)
          and s_err["true_unit_count"] >= 0.9 * len(sample),
          f"decomposed sample: {s_err}")
    return bdec


def bitmap_bits(words):
    """(..., W) uint32 bitmap words -> (..., 32 W) bool, bit v of word
    v // 32 at v."""
    words = np.ascontiguousarray(words, dtype="<u4")
    return np.unpackbits(words.view(np.uint8), axis=-1,
                         bitorder="little").astype(bool)


def scoring_inputs(call):
    """The inputs of a recorded bulk-scoring call in both forms: (clouds
    (R, T, K) int32, contig pairs ck, cp, V, P) and (read bitmaps (R, T,
    W), contig bitmap (P, W)) as uint32 numpy."""
    if call["path"] == "matmul":
        clouds, ck, cp = call["clouds"], call["ck"], call["cp"]
        V, P = call["V"], call["P"]
        contig = np.zeros((P, max(1, -(-V // 32))), np.uint32)
        keep = cp < P
        np.bitwise_or.at(contig, (cp[keep], ck[keep] // 32),
                         (np.uint32(1) << (ck[keep] % 32).astype(np.uint32)
                          ).astype(np.uint32))
        return (clouds, ck, cp, V, P), (
            scoring.clouds_to_bitmaps(clouds, V), contig)
    reads, contig = call["reads"], call["contig"]
    bits = bitmap_bits(reads)
    V, P = bits.shape[-1], contig.shape[0]
    K = max(1, int(bits.sum(-1).max()))
    order = np.argsort(~bits, axis=-1, kind="stable")[..., :K]
    clouds = np.where(np.take_along_axis(bits, order, -1), order, -1)
    cp, ck = np.nonzero(bitmap_bits(contig))
    return (clouds.astype(np.int32), ck.astype(np.int32),
            cp.astype(np.int32), V, P), (reads, contig)


@contextlib.contextmanager
def recorded_scoring(calls):
    """Records every bulk-scoring call of the placement (either scorer):
    its inputs and outputs on the host and its milliseconds on the card
    (synchronised before and after)."""
    matmul, popcount = (scoring.placement_scores_matmul,
                        scoring.placement_scores)

    def timed(fn, *args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        s0, s1 = fn(*args, **kw)
        torch.cuda.synchronize()
        return s0, s1, (time.perf_counter() - t) * 1e3

    def rec_matmul(clouds, ck, cp, n_kmers, n_pos):
        s0, s1, ms = timed(matmul, clouds, ck, cp, n_kmers=n_kmers,
                           n_pos=n_pos)
        calls.append({"path": "matmul", "clouds": clouds.cpu().numpy(),
                      "ck": ck.cpu().numpy(), "cp": cp.cpu().numpy(),
                      "V": n_kmers, "P": n_pos, "ms": ms,
                      "s0": s0.cpu().numpy(), "s1": s1.cpu().numpy()})
        return s0, s1

    def rec_popcount(reads, contig):
        s0, s1, ms = timed(popcount, reads, contig)
        calls.append({"path": "popcount",
                      "reads": reads.cpu().numpy().astype(np.uint32),
                      "contig": contig.cpu().numpy().astype(np.uint32),
                      "ms": ms, "s0": s0.cpu().numpy(),
                      "s1": s1.cpu().numpy()})
        return s0, s1

    scoring.placement_scores_matmul = rec_matmul
    scoring.placement_scores = rec_popcount
    try:
        yield
    finally:
        scoring.placement_scores_matmul = matmul
        scoring.placement_scores = popcount


def check_scoring_calls(calls, dev):
    """Every recorded call's scores against the other scorer on the card,
    on the same inputs; the first call's also against the port's CPU
    path of the scorer it took. Returns each call's (R, T, V, P)."""
    shapes = []
    for i, call in enumerate(calls):
        (clouds, ck, cp, V, P), (reads, contig) = scoring_inputs(call)
        mm = scoring.placement_scores_matmul(
            torch.from_numpy(clouds).to(dev), torch.from_numpy(ck).to(dev),
            torch.from_numpy(cp).to(dev), n_kmers=V, n_pos=P)
        pc = scoring.placement_scores(words_tensor(reads, dev),
                                      words_tensor(contig, dev))
        want = [call["s0"], call["s1"]]
        for got in (mm, pc):
            check(all(np.array_equal(g.cpu().numpy(), w)
                      for g, w in zip(got, want)),
                  f"scoring call {i}: matmul and popcount differ on the card")
        if i == 0:
            cpu = (scoring.placement_scores_matmul(
                torch.from_numpy(clouds), torch.from_numpy(ck),
                torch.from_numpy(cp), n_kmers=V, n_pos=P)
                if call["path"] == "matmul" else scoring.placement_scores(
                    words_tensor(reads, "cpu"), words_tensor(contig, "cpu")))
            check(all(np.array_equal(g.numpy(), w)
                      for g, w in zip(cpu, want)),
                  "scoring call 0: the card differs from the CPU")
        shapes.append([*clouds.shape[:2], V, P])
    return shapes


def phase_placement(world, dec, res, dev, want_digest=PLACEMENT_DIGEST):
    """Stage 4 on the card at the full world: `run_placement` (the clouds
    of stage 3's unique k-mers, then the greedy placement, its bulk
    scoring on `dev`) and `run_placement_validation`, through the port's
    entry points. Every bulk-scoring call is recorded and held against
    the other scorer on the card, the first also against the CPU. Each
    read's placement is held against its first whole unit `u0` (the
    prefix reads seed position 0 at the array's first unit): placed,
    the offsets' histogram and the share at the modal offset, and the
    validation's agreement, with the phase's seconds and peak memory.
    The greedy stops where no read reaches a valid score, at a stretch
    of units without unique k-mers; the phase prints the contig's span,
    the unique k-mers by unit around its end, and the placeable records
    (the rule holds with every k-mer of their clouds matched) placed in
    all and inside the span. Fails unless read_positions.csv is the JAX
    package's for this world (`want_digest`, PLACEMENT_DIGEST for the
    full world; None skips it for other worlds), 95% of the placed reads
    sit at the modal offset 0, and 90% of them re-map to their
    placement."""
    t0 = time.perf_counter()
    pcfg, kcfg = PlacerConfig(), KmerRecruitmentConfig()
    log = PhaseLog()
    logger = logging.getLogger("centroflye_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(log)
    calls = []
    torch.cuda.reset_peak_memory_stats()
    with recorded_scoring(calls), tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        placements, clouds = run_placement(dec, res.codes, pcfg, kcfg.k,
                                           tmp, device=dev)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t
        t = time.perf_counter()
        agree = run_placement_validation(placements, clouds, pcfg, kcfg,
                                         tmp)
        valid_s = time.perf_counter() - t
        pos_fn = os.path.join(tmp, "tr_resolution", "read_positions.csv")
        from_file = read_positions_file(pos_fn)
        with open(pos_fn, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
    peak = torch.cuda.max_memory_allocated()
    logger.removeHandler(log)
    sums = log.sums
    check(from_file == placements,
          "read_positions.csv differs from the placements")
    check(calls, "the placement made no bulk-scoring call")
    t = time.perf_counter()
    shapes = check_scoring_calls(calls, dev)
    check_s = time.perf_counter() - t
    placed = {r: p for r, p in placements.items() if p is not None}
    # placeable: the placement rule holds for the score a read would have
    # if every k-mer of its clouds matched (score1 = its k-mers, score0
    # = its non-empty clouds); with fewer, no offset can reach it
    placeable = [r for r, rc in clouds.items() if valid_score(
        pcfg, sum(len(c) > 0 for c in rc.clouds), sum(map(len, rc.clouds)))]
    # the greedy grows the contig from the prefix reads and stops where
    # no read reaches a valid score (a stretch of units without unique
    # k-mers, printed beside)
    span = max((p + clouds[r].n_units for r, p in placed.items()),
               default=0)
    inside = [r for r in placeable
              if world.u0[r] + clouds[r].n_units <= span]
    n_inside = sum(r in placed for r in inside)
    per_unit = unique_by_unit(world, res.codes, kcfg.k)
    offsets = collections.Counter(p - world.u0[r] for r, p in placed.items())
    modal, n_modal = offsets.most_common(1)[0] if offsets else (None, 0)
    n_agree = len(agree)
    seconds = {k: sums.get(k, 0.0) for k in (
        "placement_clouds", "placement_setup", "placement_scoring",
        "placement_greedy", "placement_artifact", "validation",
        "validation_artifact")}
    out = {"phase": "placement", "read_positions_sha256": digest,
           "equal_jax_placements": (None if want_digest is None
                                    else digest == want_digest),
           "records": len(dec.records),
           "unique_kmers": len(res.codes), "placed": len(placed),
           "placed_share": len(placed) / len(dec.records),
           "placeable": len(placeable),
           "placeable_placed": sum(r in placed for r in placeable),
           "contig_span_units": span, "placeable_in_span": len(inside),
           "placeable_in_span_placed": n_inside,
           "unique_once_by_unit_at_span_end": per_unit[
               max(0, span - 10):span + 30].tolist(),
           "offset_hist": dict(offsets.most_common(12)),
           "modal_offset": modal, "modal_share": n_modal / max(len(placed), 1),
           "validation_agree": n_agree,
           "agree_share": n_agree / max(len(placed), 1),
           "scoring": {"paths": sorted({c["path"] for c in calls}),
                       "calls": len(calls), "shapes_RTVP": shapes,
                       "ms": [c["ms"] for c in calls],
                       "equal_other_path_on_card": True,
                       "first_equal_cpu": True,
                       "check_seconds": check_s},
           "phase_seconds": seconds, "run_placement_seconds": place_s,
           "validation_seconds": valid_s, "max_memory_allocated": peak,
           "seconds": time.perf_counter() - t0}
    emit(out)
    check(want_digest is None or digest == want_digest,
          "read_positions.csv differs from the JAX package's placements "
          "of this world")
    check(modal == 0 and n_modal >= 0.95 * len(placed),
          f"offset {modal} holds {n_modal} of {len(placed)} placed reads")
    check(n_agree >= 0.9 * len(placed),
          f"validation: {n_agree} of {len(placed)} placed reads agree")
    return out


def valid_score(cfg, score0, score1):
    """The placement rule (stages/placement_fast.FastPlacer._valid_key)."""
    return (score1 >= 1 and score0 >= cfg.min_unit
            and score1 >= cfg.min_inters and score1 >= cfg.min_prop * score0)


def once_in_array(arr, k):
    """The k-mers that occur once in the simulated array, and where."""
    codes, valid = kmer_codes(arr, k)
    u, first, cnt = np.unique(codes[valid], return_index=True,
                              return_counts=True)
    return u[cnt == 1], np.flatnonzero(valid)[first][cnt == 1]


def unique_by_unit(world, codes, k):
    """Per unit of the simulated array, how many of `codes` occur in it
    and nowhere else in the array."""
    once, pos = once_in_array(world.arr, k)
    return np.bincount(pos[np.isin(once, codes)] // world.unit_len,
                       minlength=world.arr.size // world.unit_len)


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
    t = time.perf_counter()
    world = make_world(unit, N_UNITS)
    world_s = time.perf_counter() - t
    boundary_dec = phase_decomposition(unit, world)
    res, dec = phase_unique_kmers(unit, dev, world, world_s, boundary_dec)
    phase_placement(world, dec, res, dev)
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
