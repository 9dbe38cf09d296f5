"""Seed prefilter tables for read recruitment (host numpy), identical to
the JAX package's `ops/seed_filter.py`.

The recruitment decision is overwhelmingly negative on real data, so a
cheap exact-membership seed scan runs before the Myers alignment: rows
with too few unit seed k-mer hits cannot hold a unit alignment within the
threshold. `RecruitmentConfig.prefilter=False` gives the pure-Myers exact
path for parity runs.
"""

from __future__ import annotations

import numpy as np

from centroflye_tpu_torch.io.encoding import encode, kmer_codes, revcomp_str


def build_seed_bitmap(unit: str, k: int = 13, *, le: bool = False
                      ) -> np.ndarray:
    """Direct-address membership bitmap over all 4^k k-mers (k <= 15:
    4^13 = 8 MB of bits as uint32[4^k / 32]) of the unit's seed k-mers,
    both strands, over the doubled unit (instance-crossing seeds included).

    le=True keys the bitmap by LITTLE-endian codes (first base in the low
    2 bits): the natural order of k-mers read straight from 2-bit packed
    bytes (ops/fused_recruit packed filter path)."""
    assert k <= 15, "direct-address bitmap needs k <= 15"
    seqs = [unit + unit[:k - 1], revcomp_str(unit + unit[:k - 1])]
    bitmap = np.zeros(4 ** k // 32, dtype=np.uint32)
    for s in seqs:
        c, valid = kmer_codes(encode(s), k)
        c = c[valid].astype(np.uint64)
        if le:
            r = np.zeros_like(c)
            for i in range(k):
                r |= (((c >> np.uint64(2 * i)) & np.uint64(3))
                      << np.uint64(2 * (k - 1 - i)))
            c = r
        # collision-safe scatter-OR: fancy-index `|=` is last-write-wins
        # on duplicate word indices and silently drops bits
        np.bitwise_or.at(
            bitmap, (c >> np.uint64(5)).astype(np.int64),
            np.uint32(1) << (c & np.uint64(31)).astype(np.uint32))
    return bitmap


def host_prescan_hits(packed: np.ndarray, lens: np.ndarray,
                      bitmap_le: np.ndarray, k: int = 13) -> np.ndarray:
    """Host stage-A seed prescan over 2-bit packed rows.

    Samples ONE k-mer per 16-base u32 word (in-word phase 0) and counts
    membership in the LE-keyed seed bitmap: the device packed filter
    restricted to offset 0 (ops/fused_recruit). Rows with 0 sampled hits
    resolve as non-centromeric before upload. Rows holding in-range N
    bases must NOT be prescanned (N packs as base 0): they go to the exact
    Myers tier instead.
    """
    B, Lq = packed.shape
    assert Lq % 4 == 0
    W = packed.reshape(B, Lq // 4, 4).view(np.uint32)[..., 0]
    code = W & np.uint32((1 << (2 * k)) - 1)
    pos16 = 16 * np.arange(Lq // 4, dtype=np.int32)[None, :]
    valid = (pos16 + k) <= np.asarray(lens, np.int32)[:, None]
    got = bitmap_le[(code >> np.uint32(5)).astype(np.int64)]
    found = (((got >> (code & np.uint32(31))) & 1) == 1) & valid
    return found.sum(axis=1, dtype=np.int32)
