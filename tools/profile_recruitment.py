"""Host time of stage 1's streaming engine by function (cProfile), under
each prescan fill: `RecruitmentEngine.run` on chip_smoke.py's main_path
mix (bench.py's reads from seed 0, DXZ1, threshold 350, seg_len 10240,
batch 2048, prefilter on), after a warm-up, with the native fill and
with the numpy fill (`native_fill=False`).

    python3 tools/profile_recruitment.py [--device cuda] [--reads 8192]
        [--top 12]

One JSON line per fill: the run's seconds without the profiler, the
profiled run's seconds, and the top functions by own time (tottime),
with their calls and cumulative time. cProfile adds a cost to every
Python call but not to native code, so the profiled shares lean toward
Python. The first line is the card's name and power limit. Needs a card
unless --device cpu.
"""

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from centroflye_tpu_torch.config import RecruitmentConfig  # noqa: E402
from centroflye_tpu_torch.io.fasta import read_seq  # noqa: E402
from centroflye_tpu_torch.stages.recruitment import (  # noqa: E402
    RecruitmentEngine)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--reads", type=int, default=cs.N_READS)
    parser.add_argument("--top", type=int, default=12)
    args = parser.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    unit = read_seq(cs.UNIT_FASTA)
    reads, _ = cs.make_reads(unit, args.reads)
    cfg = RecruitmentConfig(threshold=cs.THRESHOLD, batch_size=cs.BATCH_SIZE)
    for native_fill in (True, False):
        eng = RecruitmentEngine(unit, cfg, seg_len=cs.SEG_LEN, device=dev,
                                native_fill=native_fill)
        list(eng.run(reads[:272]))               # warm-up
        sync(dev)
        t = time.perf_counter()
        list(eng.run(reads))
        sync(dev)
        run_s = time.perf_counter() - t
        prof = cProfile.Profile()
        t = time.perf_counter()
        prof.enable()
        list(eng.run(reads))
        sync(dev)
        prof.disable()
        profiled_s = time.perf_counter() - t
        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:args.top]
        print(json.dumps({
            "fill": "native" if native_fill else "numpy",
            "device": str(dev), "reads": len(reads),
            "run_seconds": run_s, "profiled_seconds": profiled_s,
            "top_tottime": [
                {"function": f"{os.path.basename(fn)}:{line}({name})",
                 "calls": nc, "tottime": tt, "cumtime": ct}
                for (fn, line, name), (_, nc, tt, ct, _) in top]}),
            flush=True)


if __name__ == "__main__":
    main()
