"""The port's cen6 path against the JAX package's on the full world of
`chip_smoke.py` (`cen6_world`: 800 D6Z1 HORs, reads at 30x). The port
runs phase cen6_pipeline on the card: `recruit_file` with the D6Z1 unit
at 550, then `MonoPipeline.decompose` (kernel K4) and `MonoPipeline.run`.
Then the JAX package:
- its `MonomerDecomposer` on a seeded sample of SAMPLE recruited reads
  must give the records the port's decomposer gives them on the card
  (and the port's SDReport the same monostrings): the JAX scan is slow,
  so it runs a sample, not the whole set;
- its `MonoPipeline(MonoConfig(), outdir).run` on the port's SDReport,
  converted to the JAX package's MonoStrings, with the same reads, must
  write the same idb/ (every db_k{k}.dot and scaffold_graph.dot) and
  polishing/ files.
Prints one JSON line with both packages' digests (`chip_smoke.tree_digest`
of idb/ and polishing/, the sha256 of polishing/scaffold_0/scaffold_0.fasta:
the two that `chip_smoke.CEN6_IDB_DIGEST` and `CEN6_SCAFFOLD_DIGEST` pin),
the files that differ, each package's seconds by stage and the checks of
the port's phase that failed (the tool runs on past them, and then exits
non-zero). Exits non-zero on any difference.

    python3 tools/cen6_vs_jax.py

Needs a card for the port, and jax with a GPU backend for the JAX
package's decomposer sample: the tool exits non-zero, before any work,
where jax has only its CPU backend, so the digests are pinned only from a
run where the JAX package computed its files itself. It builds the JAX
package's native library first (`make -C centroflye_tpu/native`) and
fails if it does not load: without it the JAX package's polish takes
other routes.
"""

import os

# jax must not take most of the card before torch has run
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import json
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

import chip_smoke as cs  # noqa: E402
from centroflye_tpu import native as jnative  # noqa: E402
from centroflye_tpu.config import MonoConfig as JMonoConfig  # noqa: E402
from centroflye_tpu.mono import pipeline as jpipeline  # noqa: E402
from centroflye_tpu.mono.monostring import MonoString  # noqa: E402
from centroflye_tpu.mono.sd_parser import SDReport  # noqa: E402
from centroflye_tpu.mono.string_decomposer import (  # noqa: E402
    MonomerDecomposer as JMonomerDecomposer)
from centroflye_tpu.stages import consensus as jconsensus  # noqa: E402
from centroflye_tpu_torch.io.fasta import iter_seqs  # noqa: E402
from centroflye_tpu_torch.mono.string_decomposer import (  # noqa: E402
    MonomerDecomposer)

SAMPLE = 16
SAMPLE_SEED = 9


def files_of(root):
    return {os.path.relpath(os.path.join(r, n), root):
            cs.sha256_of(os.path.join(r, n))
            for r, _, names in os.walk(root) for n in names}


def to_jax(sd):
    """The port's SDReport as the JAX package's."""
    return SDReport(
        monostrings={r: MonoString(name=m.name, syms=m.syms.copy(),
                                   nucl=m.nucl.copy(),
                                   n_monomers=m.n_monomers, strand=m.strand)
                     for r, m in sd.monostrings.items()},
        monomer_names=list(sd.monomer_names), n_monomers=sd.n_monomers)


def main():
    if jax.default_backend() == "cpu":
        raise SystemExit("cen6_vs_jax: jax has only its CPU backend; the "
                         "JAX package's decomposer needs a GPU backend here")
    t = time.perf_counter()
    built = jnative.build_native()
    build_s = time.perf_counter() - t
    if not (built and jnative.native_available()):
        raise SystemExit("cen6_vs_jax: the JAX package's native library did "
                         "not build (make -C centroflye_tpu/native)")
    failed = []

    def record(cond, msg):
        if not cond:
            failed.append(msg)
            print(f"cen6_vs_jax: check failed: {msg}", flush=True)
    cs.check = record
    cs.phase_device()
    dev = torch.device("cuda")
    world = cs.cen6_world()
    reads, _ = cs.make_reads(cs.read_seq(cs.UNIT_FASTA))
    with tempfile.TemporaryDirectory() as tmp:
        port = os.path.join(tmp, "port")
        os.makedirs(port)
        _, _, sd, out = cs.phase_cen6_pipeline(world, reads, dev, port,
                                               cs.int32_ops_per_s(),
                                               want=(None, None))
        recruited = list(iter_seqs(os.path.join(port, "cen_reads.fasta")))
        rng = np.random.default_rng(SAMPLE_SEED)
        pick = sorted(rng.choice(len(recruited), min(SAMPLE, len(recruited)),
                                 replace=False).tolist())
        sample = [recruited[i] for i in pick]
        t = time.perf_counter()
        port_rec = MonomerDecomposer(world.monomers,
                                     device=dev).decompose(sample)
        port_sample_s = time.perf_counter() - t
        t = time.perf_counter()
        jax_rec = JMonomerDecomposer(world.monomers).decompose(sample)
        jax_sample_s = time.perf_counter() - t
        records_equal = port_rec == jax_rec
        sample_ids = [r for r, _ in sample]
        # the sample's records, as SDReport rows, are the full run's
        port_sd = cs.MonoPipeline(cs.MonoConfig(), None, device=dev)
        resd = port_sd.decompose(world.monomers, sample)
        sd_equal = all(
            np.array_equal(resd.monostrings[r].syms, sd.monostrings[r].syms)
            and np.array_equal(resd.monostrings[r].nucl,
                               sd.monostrings[r].nucl)
            for r in sample_ids if r in sd.monostrings)

        jdir = os.path.join(tmp, "jax")
        torch.cuda.empty_cache()
        seconds, calls, polished = {}, {}, []
        t = time.perf_counter()
        with cs.timed_mono(jpipeline, jconsensus, seconds, calls, polished):
            jpipeline.MonoPipeline(JMonoConfig(), jdir).run(
                to_jax(sd), dict(recruited))
        seconds["run"] = time.perf_counter() - t
        trees = {}
        for name in ("idb", "polishing"):
            p, j = (files_of(os.path.join(d, name)) for d in (port, jdir))
            trees[name] = {
                "port": cs.tree_digest(os.path.join(port, name)),
                "jax": cs.tree_digest(os.path.join(jdir, name)),
                "files": len(p), "differ": sorted(
                    k for k in set(p) | set(j) if p.get(k) != j.get(k))[:20]}
        scaffold = "polishing/scaffold_0/scaffold_0.fasta"
        scaffold_sha = {d: cs.sha256_of(os.path.join(root, scaffold))
                        if os.path.exists(os.path.join(root, scaffold))
                        else None for d, root in (("port", port),
                                                  ("jax", jdir))}
    equal = (records_equal and sd_equal and scaffold_sha["jax"] is not None
             and scaffold_sha["port"] == scaffold_sha["jax"]
             and all(t["port"] == t["jax"] and not t["differ"]
                     for t in trees.values()))
    print(json.dumps({
        "equal": equal, "sample_reads": len(sample),
        "sample_records_equal": records_equal,
        "sample_sd_equal_full_run": sd_equal,
        "sample_seconds": {"port": port_sample_s, "jax": jax_sample_s},
        "trees": trees, "scaffold_0_sha256": scaffold_sha,
        "port_checks_failed": failed, "jax_backend": jax.default_backend(),
        "jax": jax.__version__, "jax_native_build_seconds": build_s,
        "port_stage_seconds": out["stage_seconds"],
        "jax_stage_seconds": seconds}), flush=True)
    if failed or not equal:
        raise SystemExit("cen6_vs_jax: the packages differ or a check of "
                         "the port's phase failed")


if __name__ == "__main__":
    main()
