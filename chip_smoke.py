"""On-card smoke run of the PyTorch port (centroflye_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels from csrc/, holds each against its
plain PyTorch version at the main path's shapes, then drives read
recruitment (stage 1 of cenX) on the real DXZ1 unit and a rel2-matched
read mix, and its file CLI.

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
from centroflye_tpu_torch.io.encoding import encode, revcomp
from centroflye_tpu_torch.io.fasta import iter_seqs, read_seq
from centroflye_tpu_torch.ops import _build
from centroflye_tpu_torch.ops.myers import build_peq, words_tensor
from centroflye_tpu_torch.ops.myers_cuda import (myers_hw_2strand,
                                                 myers_hw_2strand_plain)
from centroflye_tpu_torch.pipeline.simulate import (add_read_noise,
                                                    gen_random_seq)
from centroflye_tpu_torch.stages.recruitment import (RecruitmentEngine,
                                                     recruit_file)

HERE = os.path.dirname(os.path.abspath(__file__))
UNIT_FASTA = os.path.join(HERE, "centroflye_tpu", "data", "DXZ1_rc.fasta")
N_READS = 8192            # the read mix of bench.py
CEN_FRACTION = 0.02
THRESHOLD = 350
BATCH_SIZE = 2048
SEG_LEN = 10240
K_BUDGET = 128            # rows K1 scores per fused step
CLI_READS = 300
K1_REPLACES = "centroflye_tpu/ops/myers_pallas_v3.py:575"


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


def max_abs_err(a, b):
    return max(int((a[k].cpu().long() - b[k].cpu().long()).abs().max())
               for k in a)


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
    got = myers_hw_2strand(*args, m=m)
    torch.cuda.synchronize()
    t_plain = time.perf_counter()
    want = myers_hw_2strand_plain(*args, m=m)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t_plain) * 1e3
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
    return {"max_abs_err": max(err, err_s), "ms": k1_ms,
            "plain_ms": plain_ms}


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
    return reads, recruited, launches


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
    k1 = phase_k1(encode(unit), dev)
    reads, recruited, launches = phase_main_path(unit, dev)
    phase_cli(reads, recruited, dev)
    emit({"kernels": [{
        "name": "myers_hw_2strand", "route": "cuda",
        "source": "centroflye_tpu_torch/csrc/myers_hw_2strand.cu",
        "replaces": K1_REPLACES, "launches": launches, **k1}]})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
