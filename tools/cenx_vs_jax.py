"""The port's cenX pipeline against the JAX package's on the full world of
`chip_smoke.py`: the port runs stages 2-4 (`phase_decomposition`,
`phase_unique_kmers`, `phase_placement`) and then `CenXPipeline.run` on
the card (`phase_cenx_pipeline`: stage 1 on the reads file, stages 2-4
resumed, stages 5 and 6). A copy of that output directory with stages
1-4's artifacts only then goes to the JAX package's
`CenXPipeline(..., mesh=None).run`, which resumes stages 1-4 and computes
stages 5 and 6. Prints one JSON line with each package's sha256 of
cons_unit/unit_star.fasta, polishing/final_sequence_4.fasta and
final_assembly.fasta (the first and last are what
`chip_smoke.UNIT_STAR_DIGEST` and `ASSEMBLY_DIGEST` pin) and each
package's seconds by stage. Exits non-zero if a file differs.

    python3 tools/cenx_vs_jax.py

Needs a card for the port's stages, and jax with a GPU backend for the
JAX package's: stage 5's k-mer count is device work there (72 batches
of 64 padded rows, then merges of tables up to 2^28 entries), which on
jax's CPU backend did not finish within 45 minutes on the H100's host.
The tool exits non-zero, before any work, where jax has only its CPU
backend: every file it compares must be the JAX package's own, so the
digests are pinned only from a run where the JAX package counted
itself. The tool first builds the JAX package's native library as its Makefile does
(`make -C centroflye_tpu/native`, which needs zlib's headers), and fails
if that library does not load: without it the JAX package takes other
routes.
"""

import os

# jax must not take most of the card before torch has run
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import json
import shutil
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

import chip_smoke as cs  # noqa: E402
from centroflye_tpu import native as jnative  # noqa: E402
from centroflye_tpu.config import CentroFlyeConfig  # noqa: E402
from centroflye_tpu.pipeline.cenx import CenXPipeline  # noqa: E402
from centroflye_tpu_torch.io.fasta import read_seq  # noqa: E402

FILES = ("cons_unit/unit_star.fasta", "polishing/final_sequence_4.fasta",
         "final_assembly.fasta")
# what stages 5 and 6 write; the JAX package's copy starts without them
STAGE_5_6 = ("cons_unit", "polishing", "polishing2", "final_assembly.fasta",
             "metrics.json")


def main():
    if jax.default_backend() == "cpu":
        raise SystemExit("cenx_vs_jax: jax has only its CPU backend; the "
                         "JAX package's stage 5 needs a GPU backend here")
    t = time.perf_counter()
    built = jnative.build_native()
    build_s = time.perf_counter() - t
    if not (built and jnative.native_available()):
        raise SystemExit("cenx_vs_jax: the JAX package's native library did "
                         "not build (make -C centroflye_tpu/native)")
    cs.CUT_SWEEPS = {}
    cs.phase_device()
    dev = torch.device("cuda")
    unit = read_seq(cs.UNIT_FASTA)
    world = cs.make_world(unit, cs.N_UNITS)
    bdec = cs.phase_decomposition(unit, world)
    reads, cen = cs.make_reads(unit)
    background = [(r, s) for r, s in reads if r not in cen]
    with tempfile.TemporaryDirectory() as tmp:
        port = os.path.join(tmp, "port")
        res, dec = cs.phase_unique_kmers(unit, dev, world, 0.0, bdec, port)
        cs.phase_placement(world, dec, res, dev, port)
        del res, dec
        _, _, out = cs.phase_cenx_pipeline(
            unit, world, background, dev, port, cs.int32_ops_per_s(),
            want=(None, None))
        jax_dir = os.path.join(tmp, "jax")
        shutil.copytree(port, jax_dir, ignore=lambda d, names: [
            n for n in names if d == port and n in STAGE_5_6])
        torch.cuda.empty_cache()
        seconds = {}
        pipe = cs.timed_pipeline(
            CenXPipeline(unit, CentroFlyeConfig(), jax_dir, mesh=None),
            seconds, {})
        t = time.perf_counter()
        final = pipe.run(os.path.join(jax_dir, "reads.fasta"))
        seconds["run"] = time.perf_counter() - t
        digests = {name: {"port": cs.sha256_of(os.path.join(port, name)),
                          "jax": cs.sha256_of(os.path.join(jax_dir, name))}
                   for name in FILES}
    equal = all(d["port"] == d["jax"] for d in digests.values())
    print(json.dumps({
        "sha256": digests, "equal": equal, "assembly_len": len(final),
        "jax_backend": jax.default_backend(), "jax": jax.__version__,
        "jax_native_build_seconds": build_s,
        "port_stage_seconds": out["stage_seconds"],
        "jax_stage_seconds": seconds}), flush=True)
    if not equal:
        raise SystemExit("cenx_vs_jax: the packages' files differ")


if __name__ == "__main__":
    main()
