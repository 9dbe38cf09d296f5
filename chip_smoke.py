"""On-card smoke run of the PyTorch port (centroflye_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels from csrc/, holds each against its
plain PyTorch version at the main path's shapes (K1 two-strand, K2
one-strand and K3 threshold-k banded HW Myers), then drives read
recruitment (stage 1 of cenX) on the real DXZ1 unit and a rel2-matched
read mix, its file CLI, and the Myers op library's HW entry points (K2,
K3) on the exact tier's batches of that mix.

    python3 chip_smoke.py

Each phase prints one JSON line with its seconds. Any failed check exits
non-zero. Needs CUDA: without a card it fails and prints no result. The
last line is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from centroflye_tpu_torch.config import RecruitmentConfig
from centroflye_tpu_torch.io.encoding import decode, encode, revcomp
from centroflye_tpu_torch.io.fasta import iter_seqs, read_seq
from centroflye_tpu_torch.ops import _build
from centroflye_tpu_torch.ops.myers import build_peq, words_tensor
from centroflye_tpu_torch.ops.myers_cuda import (
    myers_hw_2strand, myers_hw_2strand_plain, myers_hw_v3,
    myers_hw_v3_banded, myers_hw_v3_plain, threshold_hw)
from centroflye_tpu_torch.pipeline.simulate import (add_read_noise,
                                                    gen_random_seq)
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


def phase_k1(unit_codes, dev):
    """K1 against its plain version on the card at the fused step's shape
    (k_budget rows of one segment), then a small case also against the
    plain version on the CPU."""
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
    check(err == 0, f"K1 != plain at {K_BUDGET}x{SEG_LEN}, m={m}")
    check(int(got["dist_f"][0]) == 0 and int(got["dist_r"][1]) == 0,
          "tandem rows must align exactly")
    check((int(got["dist_f"][6]), int(got["end_f"][6])) == (m, -1),
          "a row of length 0 gives (m, -1)")
    k1_ms = time_cuda(lambda: myers_hw_2strand(*args, m=m), reps=20)

    small_m = 90
    small = k1_case(rng, rng.integers(0, 4, small_m).astype(np.int8),
                    small_m, 256, 128, dev)
    got_s = myers_hw_2strand(*small, m=small_m)
    want_s = myers_hw_2strand_plain(*small, m=small_m)
    cpu_s = myers_hw_2strand(*(a.cpu() for a in small), m=small_m)
    err_s = max(max_abs_err(got_s, want_s), max_abs_err(got_s, cpu_s))
    check(err_s == 0, "K1 != plain at m=90 (card or CPU)")
    emit({"phase": "k1", "shape": [K_BUDGET, SEG_LEN], "m": m,
          "max_abs_err": err, "k1_ms": k1_ms, "plain_ms": plain_ms,
          "small_m90_max_abs_err": err_s,
          "seconds": time.perf_counter() - t0})
    kernel = {"max_abs_err": max(err, err_s), "ms": k1_ms,
              "plain_ms": plain_ms}
    return kernel, {"args": args, "want": want, "plain_f_ms": plain_f_ms,
                    "small": small, "small_m": small_m}


def phase_k2(k1, k1_ms, m):
    """K2 with peq_f, then peq_r, on phase k1's batch: each equals the
    matching strand of the plain result phase k1 computed. Then m = 90
    against the plain version on the CPU."""
    t0 = time.perf_counter()
    pf, pr, text_t, lens = k1["args"]
    want = k1["want"]
    err = 0
    for s, peq in (("f", pf), ("r", pr)):
        got = myers_hw_v3(peq, text_t, lens, m=m)
        err = max(err, max_abs_err(
            got, {"dist": want[f"dist_{s}"], "end": want[f"end_{s}"]}))
    check(err == 0, f"K2 != plain at {K_BUDGET}x{SEG_LEN}, m={m}")
    k2_ms = time_cuda(lambda: myers_hw_v3(pf, text_t, lens, m=m), reps=20)

    small_m = k1["small_m"]
    spf, spr, stext, slens = k1["small"]
    err_s = 0
    for peq in (spf, spr):
        got = myers_hw_v3(peq, stext, slens, m=small_m)
        cpu = myers_hw_v3(peq.cpu(), stext.cpu(), slens.cpu(), m=small_m)
        err_s = max(err_s, max_abs_err(got, cpu))
    check(err_s == 0, "K2 != CPU plain at m=90")
    emit({"phase": "k2", "shape": [K_BUDGET, SEG_LEN], "m": m,
          "max_abs_err": err, "k2_ms": k2_ms, "k1_ms": k1_ms,
          "plain_ms": k1["plain_f_ms"], "small_m90_max_abs_err": err_s,
          "seconds": time.perf_counter() - t0})
    return {"max_abs_err": max(err, err_s), "ms": k2_ms,
            "plain_ms": k1["plain_f_ms"]}


def phase_k3(unit_codes, dev, k1_ms, k2_ms):
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
    emit({"phase": "k3", "shape": [K_BUDGET, SEG_LEN], "m": m,
          "k": THRESHOLD, "max_abs_err": err, "rows_in_band": in_band,
          "k3_ms": k3_ms, "k2_ms_same_batch": k2_here,
          "k1_ms_same_batch": k1_here, "k2_ms_k1_batch": k2_ms,
          "k1_ms_k1_batch": k1_ms, "plain_ms": plain_ms,
          "small_max_abs_err": err_s, "seconds": time.perf_counter() - t0})
    return {"max_abs_err": max(err, err_s), "ms": k3_ms,
            "plain_ms": plain_ms[0]}


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


def phase_myers_ops(unit, reads, recruited, batches, overlap, dev):
    """The Myers op library's HW entry points on the exact tier's
    batches of the main path's mix (BATCH_SIZE x SEG_LEN, both strands):
    K2 equals K1's strand, K3 at k = THRESHOLD equals K1's strand
    thresholded, and the reads K3 would recruit are the engine's."""
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

    codes, lens = batches[0]
    text_t = torch.from_numpy(codes).to(dev).t().contiguous()
    lens_t = torch.from_numpy(lens).to(dev)
    ms = {"k1_ms": time_cuda(lambda: myers_hw_2strand(pf, pr, text_t, lens_t,
                                                      m=m), reps=5),
          "k2_ms": time_cuda(lambda: myers_hw_v3(pf, text_t, lens_t, m=m),
                             reps=5),
          "k3_ms": time_cuda(lambda: myers_hw_v3_banded(
              pf, text_t, lens_t, m=m, k=THRESHOLD), reps=5)}
    emit({"phase": "myers_ops", "batches": len(batches),
          "segments": len(seg_read), "shape": [BATCH_SIZE, SEG_LEN],
          "k": THRESHOLD, "segments_in_band": in_band,
          "recruited": len(k3_set), "k3_set_equal": True,
          "launches": launches, "run_seconds": run_s,
          "ms_at_2048_rows_batch0": ms,
          "seconds": time.perf_counter() - t0})
    return launches


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


def main():
    smi_line, kind = phase_device()
    dev = torch.device("cuda")
    phase_build()
    unit = read_seq(UNIT_FASTA)
    m = len(unit)
    k1, k1_state = phase_k1(encode(unit), dev)
    k2 = phase_k2(k1_state, k1["ms"], m)
    k3 = phase_k3(encode(unit), dev, k1["ms"], k2["ms"])
    reads, recruited, launches, batches, overlap = phase_main_path(unit, dev)
    phase_cli(reads, recruited, dev)
    ops_launches = phase_myers_ops(unit, reads, recruited, batches, overlap,
                                   dev)
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
