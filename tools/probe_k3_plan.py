"""Times the two passes of K3, the threshold-k HW Myers kernel
(`centroflye_tpu_torch/csrc/myers_hw_banded.cu`), under forced column
windows, on one NVIDIA GPU.

    python3 tools/probe_k3_plan.py [--reps N]

Batches (DXZ1, k = 350): the exact tier's batch 0 of chip_smoke.py's
read mix (2048 x 10240) and phase k3's 128 x 10240 batch. For each, pass
1 alone with S1 = L, L/2, L/3 and L/4 owned columns a window, and pass 2
alone at several S2 (each run's outputs held against K2's thresholded),
beside the plan's own choice and K2's ms on the same batch; CUDA events.
One JSON line a batch, then the card's name and power limit.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402
from centroflye_tpu_torch.config import RecruitmentConfig  # noqa: E402
from centroflye_tpu_torch.io.encoding import encode  # noqa: E402
from centroflye_tpu_torch.io.fasta import read_seq  # noqa: E402
from centroflye_tpu_torch.ops.myers_cuda import (  # noqa: E402
    BandedRun, myers_hw_v3, threshold_hw)
from centroflye_tpu_torch.stages.recruitment import \
    RecruitmentEngine  # noqa: E402

S2_CHOICES = (256, 512, 768, 1024, 1536, 2048, 4096)


def exact_tier_batch0(unit, dev):
    """(text_t, lens) of the exact tier's first 2048 x 10240 batch."""
    reads, _ = cs.make_reads(unit)
    engine = RecruitmentEngine(
        unit, RecruitmentConfig(threshold=cs.THRESHOLD,
                                batch_size=cs.BATCH_SIZE, prefilter=False),
        seg_len=cs.SEG_LEN, device=dev)
    batches = []
    score = engine.distances

    def capture(codes, lens):
        batches.append((codes, lens.copy()))
        return score(codes, lens)
    engine.distances = capture
    for _ in engine.run(reads):
        pass
    codes, lens = batches[0]
    return (torch.from_numpy(codes).to(dev).t().contiguous(),
            torch.from_numpy(lens).to(dev))


def sweep(name, peq, text_t, lens, m, reps):
    L, _ = text_t.shape
    k = cs.THRESHOLD
    k2 = myers_hw_v3(peq, text_t, lens, m=m)
    want = threshold_hw(k2, m=m, k=k)
    own = BandedRun(peq, text_t, lens, m=m, k=k)
    own.pass1()
    own.pass2()
    cs.check(cs.max_abs_err(own.result(), want) == 0, f"{name}: K3 != K2")
    pass1 = {}
    for parts in (1, 2, 3, 4):
        S = -(-L // parts)
        run = BandedRun(peq, text_t, lens, m=m, k=k, window=S)
        pass1[S] = cs.time_cuda(run.pass1, reps)
    pass2 = {}
    for S in S2_CHOICES:
        run = BandedRun(peq, text_t, lens, m=m, k=k, window=S)
        run.pass1()
        run.pass2()
        cs.check(cs.max_abs_err(run.result(), want) == 0,
                 f"{name}: K3 at S = {S} != K2")
        pass2[S] = cs.time_cuda(run.pass2, reps)
    plan = own.plan
    cs.emit({"batch": name, "shape": list(text_t.shape[::-1]),
             "r0": plan.r0, "survivors": own.survivors,
             "plan_S": [plan.pass1.S, plan.pass2.S],
             "plan_pass_ms": [cs.time_cuda(own.pass1, reps),
                              cs.time_cuda(own.pass2, reps)],
             "pass1_ms_by_S": pass1, "pass2_ms_by_S": pass2,
             "k2_ms": cs.time_cuda(
                 lambda: myers_hw_v3(peq, text_t, lens, m=m), reps)})


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "needs a CUDA card")
    dev = torch.device("cuda")
    unit = read_seq(cs.UNIT_FASTA)
    uc = encode(unit)
    m = len(unit)
    pf, _, text_t, lens = cs.k3_case(np.random.default_rng(3), uc,
                                     cs.SEG_LEN, cs.K_BUDGET, dev)
    sweep("k3_case", pf, text_t, lens, m, args.reps)
    text0, lens0 = exact_tier_batch0(unit, dev)
    sweep("exact_tier_batch0", pf, text0, lens0, m, args.reps)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
