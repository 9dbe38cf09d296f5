"""Nucleotide encodings: strings <-> int8 code arrays, 2-bit k-mer codes.

Host numpy, identical to the JAX package's `io/encoding.py`: bases are int8
codes (A=0, C=1, G=2, T=3, pad/N=4) and a k-mer is a 2-bit-packed
integer code, a numpy uint64 on the host.
"""

from __future__ import annotations

import numpy as np

ALPHABET = "ACGT"
PAD = np.int8(4)

# base char -> code lookup (256-entry), unknown chars -> PAD
_ENC = np.full(256, PAD, dtype=np.int8)
for _i, _c in enumerate(ALPHABET):
    _ENC[ord(_c)] = _i
    _ENC[ord(_c.lower())] = _i

_DEC = np.frombuffer(b"ACGTN", dtype=np.uint8)

# complement in code space: A<->T, C<->G; PAD -> PAD
_COMP = np.array([3, 2, 1, 0, 4], dtype=np.int8)


def encode(seq: str) -> np.ndarray:
    """String -> int8 code array."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ENC[raw]


def decode(codes: np.ndarray) -> str:
    """int8 code array -> string (PAD -> 'N'). Trailing PADs are kept;
    callers slice by length first."""
    codes = np.asarray(codes)
    return _DEC[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def encode_batch(seqs, max_len: int | None = None):
    """List of strings -> (codes[N, L] int8 padded with PAD, lens[N] int32)."""
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    L = int(max_len if max_len is not None else (lens.max() if len(seqs) else 0))
    out = np.full((len(seqs), L), PAD, dtype=np.int8)
    for i, s in enumerate(seqs):
        n = min(len(s), L)
        out[i, :n] = encode(s)[:n]
    return out, lens


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement in code space."""
    return _COMP[codes][::-1]


def revcomp_str(seq: str) -> str:
    """Reverse complement of a string; preserves '-' like the reference RC
    (reference utils/bio.py:27-29) and maps other unknowns to N."""
    out = []
    comp = {"A": "T", "T": "A", "G": "C", "C": "G",
            "a": "t", "t": "a", "g": "c", "c": "g", "-": "-"}
    for ch in reversed(seq):
        out.append(comp.get(ch, "N"))
    return "".join(out)


def kmer_codes(codes: np.ndarray, k: int, *, length: int | None = None):
    """All k-mer 2-bit codes of a code array (host, numpy).

    Returns (kmer_codes uint64[length-k+1], valid bool[...]) where valid marks
    windows free of PAD/N. The code packs base codes big-endian:
    code = sum(base[i] << 2*(k-1-i)) — so lexicographic k-mer order equals
    numeric order.
    """
    codes = np.asarray(codes)
    n = int(length if length is not None else len(codes))
    codes = codes[:n]
    if n < k:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    is_ok = codes < 4
    vals = np.where(is_ok, codes, 0).astype(np.uint64)
    nwin = n - k + 1
    out = np.zeros(nwin, dtype=np.uint64)
    for i in range(k):
        out |= vals[i:i + nwin] << np.uint64(2 * (k - 1 - i))
    # valid = all k bases ok: windowed AND via cumulative sums of violations
    bad = (~is_ok).astype(np.int32)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    return out, valid


def split_u64(codes_u64: np.ndarray):
    """uint64 codes -> (hi, lo) uint32 pair."""
    codes_u64 = np.asarray(codes_u64, dtype=np.uint64)
    hi = (codes_u64 >> np.uint64(32)).astype(np.uint32)
    lo = (codes_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return hi, lo


def join_u64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(hi, lo) uint32 pair -> uint64 codes."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | \
        np.asarray(lo, dtype=np.uint64)


def kmer_strings(codes_u64: np.ndarray, k: int):
    """uint64 k-mer codes -> list of strings (for artifact parity output)."""
    codes_u64 = np.asarray(codes_u64, dtype=np.uint64)
    n = len(codes_u64)
    chars = np.empty((n, k), dtype=np.uint8)
    for i in range(k):
        shift = np.uint64(2 * (k - 1 - i))
        chars[:, i] = _DEC[((codes_u64 >> shift) & np.uint64(3)).astype(np.int8)]
    return [row.tobytes().decode("ascii") for row in chars]


def string_to_kmer_code(kmer: str) -> int:
    """Single k-mer string -> integer code (host). Rejects non-ACGT
    characters: _ENC maps them to 4, which would overflow the 2-bit slot
    and silently corrupt the code (e.g. on re-loading a hand-edited
    unique_kmers artifact in the resume path)."""
    code = 0
    for ch in kmer:
        v = int(_ENC[ord(ch)])
        if v >= 4:
            raise ValueError(f"non-ACGT character {ch!r} in k-mer {kmer!r}")
        code = (code << 2) | v
    return code
