"""Typed configuration of the port: the same fields and defaults as
the JAX package's `config.py`, for the stages ported so far."""

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
