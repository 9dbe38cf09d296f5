"""Typed configuration of the port: the same fields and defaults as
the JAX package's `config.py`, for the stages ported so far (read
recruitment, unit decomposition, rare and unique k-mers, placement)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RecruitmentConfig:
    """Read recruitment (reference scripts/read_recruitment/rr.cpp:41-90,
    run_read_recruitment.sh:29-31; run_all_cen6.sh:17)."""

    # Edit-distance threshold for HW-mode unit-vs-read alignment.
    # 350 for DXZ1/cenX (default), 550 for D6Z1/cen6.
    threshold: int = 350
    # Segments per host prescan batch and per exact-tier batch when the
    # prefilter is off.
    batch_size: int = 2048
    # Reads longer than this are scanned in chunks with (unit+threshold)-sized
    # overlap so an instance spanning a boundary is not missed.
    max_read_len: int = 131072
    # Seed prefilter (ops/seed_filter): segments with fewer than
    # min_seed_hits unit seed-k-mer hits skip the alignment kernel. Set
    # prefilter=False for the pure-Myers exact path (parity runs).
    prefilter: bool = True
    seed_k: int = 13
    min_seed_hits: int = 8
    # Kept for field parity with the JAX config; the port has no
    # multi-device mesh, so no sequence-parallel tier reads it.
    seq_parallel_min_len: int = 3 * 32768


@dataclasses.dataclass(frozen=True)
class UnitDecompositionConfig:
    """NCRF-equivalent tandem decomposition of reads into unit instances
    (replaces the external NCRF binary; artifact-compatible with
    reference scripts/ncrf_parser.py parsing)."""

    # Only the longest alignment of a read is kept, and only if it is at least
    # this long (reference ncrf_parser.py:61 min_record_len).
    min_record_len: int = 5000
    # Seed k-mer length used to anchor unit instances within a read.
    seed_k: int = 15
    # Max divergence allowed when validating a unit instance (fractional).
    max_unit_divergence: float = 0.35


@dataclasses.dataclass(frozen=True)
class KmerRecruitmentConfig:
    """Rare/unique k-mer recruitment
    (reference distance_based_kmer_recruitment.py:15-36 defaults)."""

    k: int = 19
    min_coverage: int = 4          # minCov of an edge in the distance graph
    min_distance: int = 1
    max_distance: int = 150
    bottom: float = 0.9
    top: float = 3.0
    kmer_survival_rate: float = 0.34
    max_nonuniq: int = 3
    rel_threshold: float = 0.8     # distance-consistency (filter_dist_tuples)
    min_nreads: int = 0
    max_nreads: int = 2**63 - 1
    # Coverage-adaptive edge cutoff: the reference's fixed min_coverage=4
    # assumes its coverage-32 datasets; below ~16x UL coverage true-pair
    # edge counts drop under 4 and the stage starves. When on, ONE sweep
    # at the floor cutoff 2 yields every cutoff's exact edge set by freq
    # thresholding, and the largest non-starved cutoff <= min_coverage is
    # chosen (stages/distance_graph.recruit_unique_kmers). Off by default:
    # parity runs need the reference's fixed semantics.
    auto_min_coverage: bool = False
    # "non-starved" = unique k-mers >= this fraction of the rare set
    # (healthy runs measure >30%, collapsed runs <5%)
    auto_min_unique_frac: float = 0.15
    # endpoint-degree cleanup at sub-reference cutoffs: keep only
    # k-mers incident to >= this many surviving edges (true unique
    # k-mers pair with tens of unit copies; chance noise pairs are
    # nearly isolated). 1 disables.
    auto_min_degree: int = 3


@dataclasses.dataclass(frozen=True)
class PlacerConfig:
    """Read placement (reference read_placer.py:131-170 defaults)."""

    n_motif: int = 1
    k_cloud: int = 19
    min_cloud_kmer_freq: int = 2
    min_kmer_mult: int = 2
    min_unit: int = 2              # threshold on score[0]
    min_inters: int = 10           # threshold on score[1]
    min_prop: int = 3              # score[1] >= min_prop * score[0]
    prefix_threshold: int = 50000  # read classification large_threshold
    small_threshold: int = 1000    # read classification small_threshold


# The JAX package's CentroFlyeConfig.coverage default: the read coverage
# the rare band is scaled by (reference centroFlye.py --coverage).
COVERAGE = 32
