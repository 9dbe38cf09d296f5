"""The multi-device dry run: the port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip`.

    python -m centroflye_tpu_torch.parallel.dryrun 4 [--device cuda:0]

runs the production pipeline's sharded steps once, on tiny shapes, on an
n-device mesh: the recruitment engine's fused tier (filter, compaction and
K1 on each shard), the rare-k-mer stats table, the distance-pair table,
the placement scorer with its global winner, and the sequence-parallel
Myers (K5) against the single-device scan. It builds and loads the CUDA
kernels and warms every device of the mesh before anything moves between
devices: a device that is still loading when another hands it work is how
a multi-device run stalls at its first exchange.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch



def warm_devices(devices) -> None:
    """Build and load the kernels (on a card) and run one small K1 launch
    on every distinct device, each synchronised, before any device hands
    another work."""
    from centroflye_tpu_torch.ops.myers import build_peq, words_tensor
    from centroflye_tpu_torch.ops.myers_cuda import myers_hw_2strand

    distinct = list(dict.fromkeys(torch.device(d) for d in devices))
    if any(d.type == "cuda" for d in distinct):
        from centroflye_tpu_torch.ops._build import load_library
        load_library()
    peq = build_peq(np.zeros(8, np.int8))
    for d in distinct:
        p = words_tensor(peq, d)
        myers_hw_2strand(p, p, torch.zeros((16, 1), dtype=torch.int8,
                                           device=d),
                         torch.full((1,), 16, dtype=torch.int32, device=d),
                         m=8)
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> dict:
    """Runs the sharded steps on a mesh of `devices` (default: the first
    n_devices local cards; raises if there are fewer). Returns what each
    step produced; raises if a step's result is wrong."""
    from centroflye_tpu_torch.config import (KmerRecruitmentConfig,
                                             RecruitmentConfig)
    from centroflye_tpu_torch.io.encoding import encode, encode_batch
    from centroflye_tpu_torch.io.fasta import read_seq
    from centroflye_tpu_torch.ops.myers import (build_peq,
                                                myers_distance_batch,
                                                words_tensor)
    from centroflye_tpu_torch import DATA_DIR
    from centroflye_tpu_torch.ops.scoring import clouds_to_bitmaps
    from centroflye_tpu_torch.parallel.mesh import (
        make_mesh, make_placement_score_step)
    from centroflye_tpu_torch.parallel.seq_parallel import (
        make_seq_mesh, myers_distance_seqparallel)
    from centroflye_tpu_torch.pipeline.simulate import (add_read_noise,
                                                        gen_random_seq)
    from centroflye_tpu_torch.stages.distance_graph import (
        build_distance_table)
    from centroflye_tpu_torch.stages.rare_kmers import get_rare_kmers
    from centroflye_tpu_torch.stages.recruitment import RecruitmentEngine

    if devices is None:
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"need {n_devices} cards, have "
                               f"{torch.cuda.device_count()}; pass "
                               f"devices= to repeat one")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    mesh = make_mesh(n_devices, devices=devices)
    warm_devices(mesh.devices)
    rng = np.random.default_rng(0)
    out = {"devices": [str(d) for d in mesh.devices]}

    # 1) the production recruitment engine, fused tier sharded
    unit = read_seq(os.path.join(DATA_DIR, "DXZ1_rc.fasta"))[:200]
    reads = [(f"r{i}", add_read_noise(rng, unit * 3, 0.08) if i % 2 == 0
              else gen_random_seq(rng, 1200)) for i in range(2 * n_devices)]
    eng = RecruitmentEngine(
        unit, RecruitmentConfig(threshold=50, batch_size=n_devices,
                                min_seed_hits=4),
        seg_len=2048, device=mesh.first, mesh=mesh)
    out["recruited"] = sum(r.recruited for r in eng.run(reads))
    if out["recruited"] != n_devices:
        raise RuntimeError(f"dry run: {out['recruited']} of {n_devices} "
                           f"tandem reads recruited")

    # 2) the rare-k-mer stats table, shards folded
    kcfg = KmerRecruitmentConfig(k=13, min_distance=1, max_distance=12,
                                 min_coverage=2, bottom=0.0, top=1e9)
    seqs = [add_read_noise(rng, unit * 4, 0.05)
            for _ in range(2 * n_devices)]
    out["rare_kmers"] = len(get_rare_kmers(
        seqs, kcfg, coverage=1, batch_rows=n_devices, device=mesh.first,
        mesh=mesh))

    # 3) the distance-pair table, chunks split by shard
    R, T, K = 2 * n_devices, 10, 4
    clouds = np.where(rng.random((R, T, K)) < 0.8,
                      rng.integers(0, 50, size=(R, T, K)),
                      -1).astype(np.int32)
    out["distance_keys"] = build_distance_table(
        clouds, np.full(R, T, np.int32), kcfg, entry_chunk=8 * n_devices,
        device=mesh.first, mesh=mesh)[3]

    # 4) placement scores and their global winner
    read_bm = clouds_to_bitmaps(clouds, 64)
    contig_bm = rng.integers(0, 2**31, size=(8, 2)).astype(np.uint32)
    _, _, best = make_placement_score_step(mesh)(
        words_tensor(read_bm, "cpu"), words_tensor(contig_bm, "cpu"))
    out["placement_best"] = best.tolist()

    # 5) sequence-parallel Myers against the single-device scan
    peq = build_peq(encode(unit))
    codes, lens = encode_batch([add_read_noise(rng, unit * 3, 0.08)
                                for _ in range(n_devices)], max_len=1024)
    sp = myers_distance_seqparallel(
        peq, codes, lens, m=len(unit),
        mesh=make_seq_mesh(n_devices, devices=mesh.devices))
    ref = myers_distance_batch(words_tensor(peq, "cpu"),
                               torch.from_numpy(codes),
                               torch.from_numpy(lens), m=len(unit))
    if not np.array_equal(sp["dist"], ref["dist"].numpy()):
        raise RuntimeError("dry run: the sequence-parallel distances "
                           "differ from the single-device scan")
    out["seqpar_dist"] = sp["dist"].tolist()
    for d in dict.fromkeys(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    return out


def main(argv=None):
    import argparse
    import json

    parser = argparse.ArgumentParser(description="multi-device dry run")
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", help="repeat this one device n times "
                        "(default: the first n local cards)")
    args = parser.parse_args(argv)
    devices = [args.device] * args.n_devices if args.device else None
    print(json.dumps(dryrun_multichip(args.n_devices, devices)))


if __name__ == "__main__":
    main()
