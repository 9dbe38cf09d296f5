"""The port's greedy placement against the JAX package's on the full cenX
world of `chip_smoke.py`: the port runs stages 2 and 3 on the card
(`phase_decomposition`, `phase_unique_kmers`), then both packages place
the same records with the same unique k-mers, the port with its bulk
scoring on the card, the JAX package on the CPU. Prints one JSON line
with the sha256 of each package's read_positions.csv (the number that
`chip_smoke.PLACEMENT_DIGEST` pins), the placed reads, the seconds of
each, and where the contig stops: the unique k-mers once in the array
by unit, and every stretch of 8 or more units without one. Exits
non-zero if the two files differ.

    JAX_PLATFORMS=cpu python3 tools/placement_vs_jax.py

Needs a card for the port's stages and jax for the JAX package (CPU).
"""

import hashlib
import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from centroflye_tpu.config import PlacerConfig as JaxPlacerConfig  # noqa
from centroflye_tpu.stages import kmer_cloud as jkc  # noqa: E402
from centroflye_tpu.stages.read_placer import ReadPlacer  # noqa: E402
from centroflye_tpu_torch.config import (KmerRecruitmentConfig,  # noqa
                                         PlacerConfig)
from centroflye_tpu_torch.io.fasta import read_seq  # noqa: E402
from centroflye_tpu_torch.pipeline.cenx import run_placement  # noqa: E402


def digest(fn):
    with open(fn, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def deserts(per_unit, min_len=8):
    """[first unit, length] of each run of min_len or more zeros."""
    out, start = [], None
    for i, c in enumerate(list(per_unit) + [1]):
        if c == 0 and start is None:
            start = i
        elif c and start is not None:
            if i - start >= min_len:
                out.append([start, i - start])
            start = None
    return out


def main():
    cs.CUT_SWEEPS = {}
    cs.phase_device()
    unit = read_seq(cs.UNIT_FASTA)
    world = cs.make_world(unit, cs.N_UNITS)
    bdec = cs.phase_decomposition(unit, world)
    res, dec = cs.phase_unique_kmers(unit, torch.device("cuda"), world, 0.0,
                                     bdec)
    k = KmerRecruitmentConfig().k
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        placements, clouds = run_placement(dec, res.codes, PlacerConfig(), k,
                                           tmp, device="cuda")
        port_s = time.perf_counter() - t
        port = digest(os.path.join(tmp, "tr_resolution",
                                   "read_positions.csv"))
        t = time.perf_counter()
        records = {r: dec.records[r] for r in sorted(dec.records)}
        jclouds = jkc.filter_read_clouds(
            jkc.build_read_clouds(records, res.codes, k), min_mult=2)
        placer = ReadPlacer(JaxPlacerConfig())
        jplacements = placer.run(dec, jclouds)
        jax_s = time.perf_counter() - t
        placer.write_positions(os.path.join(tmp, "jax.csv"))
        jax = digest(os.path.join(tmp, "jax.csv"))
    placed = {r: p for r, p in placements.items() if p is not None}
    span = max(p + clouds[r].n_units for r, p in placed.items())
    per_unit = cs.unique_by_unit(world, res.codes, k)
    print(json.dumps({
        "read_positions_sha256": {"port": port, "jax": jax},
        "equal": port == jax and placements == jplacements,
        "placed": len(placed), "records": len(placements),
        "contig_span_units": span, "port_seconds": port_s,
        "jax_seconds": jax_s,
        "units_with_unique_once": int((per_unit > 0).sum()),
        "unique_once_per_unit": float(per_unit.mean()),
        "deserts_8_units_or_more": deserts(per_unit)}), flush=True)
    if port != jax or placements != jplacements:
        raise SystemExit("placement_vs_jax: the packages' placements differ")


if __name__ == "__main__":
    main()
