"""ctypes bindings to the port's native Myers engine.

`myers.cpp` and `cfnative.h` beside this file are the JAX package's
native alignment engine, copied: 64-bit-word Myers edit distance in the
NW, SHW and HW modes, with a banded early-out, and alignment paths with
traceback. The library is built with g++ on first use into
`centroflye_tpu_torch/_build/`, under a name that carries a hash of the
source and the flags, so an edited source builds anew. A failed build
raises: nothing falls back to another path. The JAX package's reader and
2-bit packer (`seqio.cpp`, which links zlib) are not part of it.

The wrappers take and return what the JAX package's `native` wrappers
do, except that they raise where those return None for a missing
library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from centroflye_tpu_torch.io.encoding import encode

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("myers.cpp", "cfnative.h")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# no -march=native: the library must load on whichever host runs it
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared"]

MODE_NW, MODE_SHW, MODE_HW = 0, 1, 2
_MODES = {"NW": MODE_NW, "SHW": MODE_SHW, "HW": MODE_HW}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_PI32 = ctypes.POINTER(ctypes.c_int32)
# C entry points: name -> (restype, argtypes)
SIGNATURES = {
    "cf_edit_distance": (_I32, [_P, _I32, _P, _I32, _I32, _I32, _PI32]),
    "cf_edit_distance_batch": (None, [_P, _I32, _P, _P, _I32, _I32, _I32,
                                      _I32, _P, _P]),
    "cf_align_path": (_I32, [_P, _I32, _P, _I32, _I32, ctypes.c_char_p,
                             _I32, _PI32, _PI32]),
    "cf_align_path_batch": (None, [_P, _P, _I32, _I64, _P, _I32, _I32, _I32,
                                   _P, _P, _P, ctypes.c_char_p, _I64]),
    "cf_align_path_pairs": (None, [_P, _P, _I64, _P, _P, _I64, _I32, _I32,
                                   _I32, _P, _P, _P, ctypes.c_char_p, _I64]),
}


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libcfnative_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile myers.cpp with g++ unless the library for this source and
    these flags exists. Returns its path; raises if g++ is missing or
    fails. The build writes a private file and renames it into place, so
    processes that build at once do not see each other's half-written
    library."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native Myers library needs "
                           "it on PATH")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, os.path.join(_DIR, "myers.cpp"), "-o", tmp],
        capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed on native/myers.cpp:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    lib = ctypes.CDLL(build())
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def native_edit_distance(query_codes: np.ndarray, target_codes: np.ndarray,
                         mode: str = "HW", k: int = -1) -> Tuple[int, int]:
    """(dist, end): dist == -1 means distance > k (banded early-out)."""
    lib = load_library()
    q = np.ascontiguousarray(query_codes, dtype=np.int8)
    t = np.ascontiguousarray(target_codes, dtype=np.int8)
    end = ctypes.c_int32(-1)
    d = lib.cf_edit_distance(q.ctypes.data, len(q), t.ctypes.data, len(t),
                             _MODES[mode], k, ctypes.byref(end))
    return int(d), int(end.value)


def native_edit_distance_batch(query_codes: np.ndarray,
                               targets: np.ndarray, lens: np.ndarray,
                               mode: str = "HW", k: int = -1
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """Batch distances: targets (R, L) int8 padded; returns (dists, ends)
    int32."""
    lib = load_library()
    q = np.ascontiguousarray(query_codes, dtype=np.int8)
    t = np.ascontiguousarray(targets, dtype=np.int8)
    ln = np.ascontiguousarray(lens, dtype=np.int32)
    R, L = t.shape
    if ln.shape != (R,) or (R and (ln.min() < 0 or ln.max() > L)):
        raise ValueError(f"lens {ln.shape} must give each of the {R} rows "
                         f"a length in [0, {L}]")
    dists = np.empty(R, dtype=np.int32)
    ends = np.empty(R, dtype=np.int32)
    lib.cf_edit_distance_batch(
        q.ctypes.data, len(q), t.ctypes.data, ln.ctypes.data, R, L,
        _MODES[mode], k, dists.ctypes.data, ends.ctypes.data)
    return dists, ends


def native_align_path(query_codes: np.ndarray, target_codes: np.ndarray,
                      mode: str = "NW"
                      ) -> Optional[Tuple[int, str, int, int]]:
    """(dist, cigar, t_start, t_end), or None if the alignment failed
    (an empty query or target)."""
    lib = load_library()
    q = np.ascontiguousarray(query_codes, dtype=np.int8)
    t = np.ascontiguousarray(target_codes, dtype=np.int8)
    cap = 16 * (len(q) + len(t)) + 64
    buf = ctypes.create_string_buffer(cap)
    t_start = ctypes.c_int32(0)
    t_end = ctypes.c_int32(0)
    d = lib.cf_align_path(
        q.ctypes.data, len(q), t.ctypes.data, len(t), _MODES[mode],
        buf, cap, ctypes.byref(t_start), ctypes.byref(t_end))
    if d < 0:
        return None
    return (int(d), buf.value.decode("ascii"), int(t_start.value),
            int(t_end.value))


def native_hw_locate(query: str, target: str
                     ) -> Optional[Tuple[int, int, int]]:
    """(dist, t_start, t_end) via the native HW path alignment."""
    res = native_align_path(encode(query), encode(target), mode="HW")
    if res is None:
        return None
    d, _, st, en = res
    return d, st, en


def _padded(seqs, stride: int) -> Tuple[np.ndarray, np.ndarray]:
    """Code arrays -> ((n, stride) int8 padded with 4, (n,) int32 lens)."""
    buf = np.full((len(seqs), stride), 4, dtype=np.int8)
    lens = np.empty(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        a = np.ascontiguousarray(s, dtype=np.int8)
        buf[i, :len(a)] = a
        lens[i] = len(a)
    return buf, lens


def _split_cigars(cigars, n: int, cap: int, dists, t_starts, t_ends):
    raw = cigars.raw     # materialize the buffer ONCE (`.raw` copies)
    return [(int(dists[i]),
             raw[i * cap:(i + 1) * cap].split(b"\0", 1)[0].decode("ascii"),
             int(t_starts[i]), int(t_ends[i])) for i in range(n)]


def native_align_path_batch(queries, target_codes: np.ndarray,
                            mode: str = "NW", threads: int = 0):
    """Traceback alignments of many queries (int8 code arrays) against
    one target, on `threads` native threads (0: one per core). Returns a
    list of (dist, cigar, t_start, t_end), dist -1 where one failed."""
    lib = load_library()
    n = len(queries)
    if n == 0:
        return []
    t = np.ascontiguousarray(target_codes, dtype=np.int8)
    stride = max(1, max(len(q) for q in queries))
    qbuf, qlens = _padded(queries, stride)
    cap = 16 * (stride + len(t)) + 64
    cigars = ctypes.create_string_buffer(n * cap)
    dists, t_starts, t_ends = (np.empty(n, dtype=np.int32)
                               for _ in range(3))
    lib.cf_align_path_batch(
        qbuf.ctypes.data, qlens.ctypes.data, n, stride, t.ctypes.data,
        len(t), _MODES[mode], threads, dists.ctypes.data,
        t_starts.ctypes.data, t_ends.ctypes.data, cigars, cap)
    return _split_cigars(cigars, n, cap, dists, t_starts, t_ends)


def native_align_path_pairs(queries, targets, mode: str = "HW",
                            threads: int = 0):
    """Traceback alignments over independent (query, target) pairs of
    int8 code arrays, on `threads` native threads (0: one per core).
    Returns a list of (dist, cigar, t_start, t_end), dist -1 where one
    failed."""
    lib = load_library()
    n = len(queries)
    if n != len(targets):
        raise ValueError("queries/targets length mismatch")
    if n == 0:
        return []
    qstride = max(1, max(len(q) for q in queries))
    tstride = max(1, max(len(t) for t in targets))
    qbuf, qlens = _padded(queries, qstride)
    tbuf, tlens = _padded(targets, tstride)
    # a length-L run costs len(str(L)) + 1 <= 3*L bytes for L == 1 and
    # strictly less per-base beyond; 4x the op bound is safely above
    cap = 4 * (qstride + tstride) + 64
    cigars = ctypes.create_string_buffer(n * cap)
    dists, t_starts, t_ends = (np.empty(n, dtype=np.int32)
                               for _ in range(3))
    lib.cf_align_path_pairs(
        qbuf.ctypes.data, qlens.ctypes.data, qstride, tbuf.ctypes.data,
        tlens.ctypes.data, tstride, n, _MODES[mode], threads,
        dists.ctypes.data, t_starts.ctypes.data, t_ends.ctypes.data,
        cigars, cap)
    return _split_cigars(cigars, n, cap, dists, t_starts, t_ends)
