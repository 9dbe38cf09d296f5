"""PyTorch / CUDA port of the JAX package for one NVIDIA H100.

Module names mirror the JAX package beside this one, which stays the
reference every module here is tested against. This package imports
torch and numpy only: never jax, never the JAX package. CUDA kernels
live in `csrc/` and are built with nvcc on first use (`ops/_build.py`).

Ported so far: the whole cenX pipeline, `pipeline/cenx.CenXPipeline`
(and its CLI, `python -m centroflye_tpu_torch.pipeline.cenx`), from a
reads file to final_assembly.fasta, its artifacts byte for byte the JAX
package's:
- stage 1, read recruitment (`stages/recruitment.py`), and the op
  modules under it (Myers, k-mer packing and lookup, seed filter, fused
  step), with a Hopper kernel for each of the JAX package's Pallas
  kernels: two-strand and one-strand HW Myers in
  `csrc/myers_hw_2strand.cu`, threshold-k banded HW Myers in
  `csrc/myers_hw_banded.cu`;
- stage 2, unit decomposition (`stages/unit_decomposition.py`,
  `stages/ncrf_compat.py`), host numpy with the port's own copy of the
  JAX package's native Myers engine in `native/`, built with g++ on
  first use;
- stage 3, rare k-mers and the distance-graph unique k-mers
  (`stages/rare_kmers.py`, `stages/kmer_cloud.py`,
  `stages/distance_graph.py`);
- stage 4, greedy placement and its validation (`ops/scoring.py`,
  `stages/cloud_contig.py`, `stages/placement_fast.py`,
  `stages/read_placer.py`);
- stage 5, the consensus unit (`stages/consensus_unit.py`: a device
  k-mer count, host graph surgery, `ops/align_path.py`);
- stage 6, per-position polishing and the final polish
  (`stages/consensus.py`, `stages/polisher.py`,
  `stages/final_polish.py`), host numpy and the native engine;
- `config.CentroFlyeConfig` (its JSON is the JAX package's),
  `utils/bio.py`, `utils/logging_utils.py` (metrics.json).
The device work of stages 3-5 is plain PyTorch: the JAX package has no
Pallas kernel there.

Also ported: the cen6 pipeline (centroFlyeMono), `mono/pipeline.MonoPipeline`
and its CLI (`python -m centroflye_tpu_torch.mono.pipeline`): the monomer
decomposer (`mono/string_decomposer.py`), whose lockstep steps run on
kernel K4, per-row-query Myers (`csrc/myers_perrow.cu`, the counterpart
of the JAX package's `ops/myers.myers_distance_batch` scan), and host
copies of the monostring, SD report, error correction, monomer de
Bruijn and scaffolding modules.

Also ported: multi-device execution (`parallel/`: a device mesh, the
sharded steps of stages 1 and 3 and of the monomer decomposer, the
sequence-parallel long-read tier on kernel K5, `csrc/myers_carry.cu`,
and the multi-process file driver); the native reader and one-scan
2-bit packer (`native/seqio.cpp`) that feed stage 1's fill; the
simulator's read sets and CLI (`pipeline/simulate.py`), the NCRF-like
report writer (`stages/ncrf_compat.py`), de novo unit extraction and
its CLI (`stages/unit_extraction.py`), and the end-to-end cenX runner
(`python -m centroflye_tpu_torch.run_all_cenx`). The unit and monomer
FASTA files the port reads are its own copies, in `data/`.
"""

import os

from centroflye_tpu_torch.config import CentroFlyeConfig  # noqa: F401

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
