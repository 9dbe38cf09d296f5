"""PyTorch / CUDA port of the JAX package for one NVIDIA H100.

Module names mirror the JAX package beside this one, which stays the
reference every module here is tested against. This package imports
torch and numpy only: never jax, never the JAX package. CUDA kernels
live in `csrc/` and are built with nvcc on first use (`ops/_build.py`).

Ported so far: stage 1 of cenX, read recruitment
(`stages/recruitment.py`), and the op modules under it (Myers, k-mer
packing and lookup, seed filter, fused step), with a Hopper kernel for
each of the JAX package's Pallas kernels: two-strand and one-strand HW
Myers in `csrc/myers_hw_2strand.cu`, threshold-k banded HW Myers in
`csrc/myers_hw_banded.cu`. Then stage 3, rare k-mers and the
distance-graph unique k-mers (`pipeline/cenx.py::run_unique_kmers` over
`stages/rare_kmers.py`, `stages/kmer_cloud.py` and
`stages/distance_graph.py`), whose device work is plain PyTorch: the JAX
package has no Pallas kernel there.
"""
