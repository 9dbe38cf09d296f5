"""End-to-end cenX runner: build the native library, recruit the reads
against DXZ1, assemble (the role of the reference's run_all_cenX.sh:7-22,
and the port's counterpart of the JAX package's `run_all_cenX.py`).

    python -m centroflye_tpu_torch.run_all_cenx <reads.fasta[.gz]> <outdir>
        [coverage] [--distributed] [--device cpu]

coverage defaults to 32. The device stages run on the card unless
`--device cpu` is given. --distributed: every process of a gloo group
runs this same command (`parallel/distributed.init_distributed` reads
MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE); the reads are sharded
round robin over the processes for recruitment, and process 0 runs the
later stages on the merged file.
"""

from __future__ import annotations

import argparse
import os

from centroflye_tpu_torch import DATA_DIR


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(
        description="centroflye_tpu_torch end-to-end cenX run")
    parser.add_argument("reads", help="reads FASTA/FASTQ(.gz)")
    parser.add_argument("outdir")
    parser.add_argument("coverage", type=int, nargs="?", default=32)
    parser.add_argument("--distributed", action="store_true",
                        help="shard recruitment over a gloo process group")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the device stages "
                        "(default cuda)")
    args = parser.parse_args(argv)

    from centroflye_tpu_torch import native
    from centroflye_tpu_torch.config import CentroFlyeConfig
    from centroflye_tpu_torch.io import read_seq
    from centroflye_tpu_torch.pipeline.cenx import CenXPipeline

    native.build()                      # raises if g++ fails
    distributed = args.distributed
    if distributed:
        from centroflye_tpu_torch.parallel.distributed import (
            init_distributed)
        distributed = init_distributed()

    unit = read_seq(os.path.join(DATA_DIR, "DXZ1_rc.fasta"))
    pipe = CenXPipeline(unit, CentroFlyeConfig(coverage=args.coverage),
                        args.outdir, device=args.device,
                        distributed=distributed)
    final = pipe.run(args.reads)
    if final:
        print(f"final assembly: {len(final)} bp -> "
              f"{os.path.join(args.outdir, 'final_assembly.fasta')}")
    return final


if __name__ == "__main__":
    main()
