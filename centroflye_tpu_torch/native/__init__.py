"""ctypes bindings to the port's native runtime.

`myers.cpp`, `seqio.cpp` and `cfnative.h` beside this file are the JAX
package's native runtime, copied:
- a 64-bit-word Myers edit-distance engine in the NW, SHW and HW modes,
  with a banded early-out, and alignment paths with traceback;
- a streaming FASTA/FASTQ reader (plain or gzipped, through zlib) that
  writes int8 base codes, and two 2-bit packers for stage 1's fill: one
  over a code matrix (`cf_pack2bit`) and one straight from ASCII bases
  (`cf_encode_pack_row`, encode and pack in one scan).
The library is built with g++ on first use into
`centroflye_tpu_torch/_build/`, under a name that carries a hash of the
sources and the flags, so an edited source builds anew. A failed build
raises: nothing falls back to another path.

The wrappers take and return what the JAX package's `native` wrappers
do, except that they raise where those return None for a missing
library or symbol. `native_pack2bit` still returns None for a row
length that is not a multiple of 8: that is its contract on the shape.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Iterator, Optional, Tuple

import numpy as np

from centroflye_tpu_torch.io.encoding import encode

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("myers.cpp", "seqio.cpp", "cfnative.h")
COMPILED = tuple(n for n in SOURCES if n.endswith(".cpp"))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# no -march=native: the library must load on whichever host runs it
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared"]
# after the sources: g++ links --as-needed on some systems, and drops a
# library named before the objects that use it
LDLIBS = ["-lz"]

MODE_NW, MODE_SHW, MODE_HW = 0, 1, 2
_MODES = {"NW": MODE_NW, "SHW": MODE_SHW, "HW": MODE_HW}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_PI32 = ctypes.POINTER(ctypes.c_int32)
# C entry points: name -> (restype, argtypes)
SIGNATURES = {
    "cf_reader_open": (_P, [ctypes.c_char_p]),
    "cf_reader_close": (None, [_P]),
    "cf_reader_next": (_I64, [_P, _P, _I64, ctypes.c_char_p, _I32]),
    "cf_pack2bit": (_I32, [_P, _I64, _I64, _P, _P, _P]),
    "cf_encode_pack_row": (_I32, [ctypes.c_char_p, _I64, _I64, _P, _I64]),
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
    h = hashlib.sha256(" ".join(CXX_FLAGS + LDLIBS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libcfnative_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources with g++ unless the library for these sources
    and flags exists. Returns its path; raises if g++ is missing or
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
        [cxx, *CXX_FLAGS, *(os.path.join(_DIR, n) for n in COMPILED),
         "-o", tmp, *LDLIBS],
        capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed on native/{' '.join(COMPILED)}:\n"
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


def get_encode_pack():
    """The raw ctypes `cf_encode_pack_row`: encode and 2-bit pack the
    ASCII bases seq[start:start + length] straight into one packed row,
    one scan, no int8 intermediate. Signature: (seq_bytes, start, length,
    out_ptr, out_bytes) -> 1 if a non-ACGT character was in range (the
    caller routes the row to the exact tier), 0 if clean, -1 if out_bytes
    is too small. Callers do their own pointer arithmetic per row: this
    is the streaming engine's fill."""
    return load_library().cf_encode_pack_row


def get_pack2bit_row():
    """The raw ctypes `cf_pack2bit`, for one row of int8 codes at a time
    (the native reader's input): the caller passes rows=1 and a
    one-element lens array; it returns 1 if an in-range code is >= 4."""
    return load_library().cf_pack2bit


def native_iter_seqs(path: str, max_len: int = 1 << 24
                     ) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (r_id, int8 code array) records through the native reader:
    FASTA or FASTQ, plain or gzipped. The id runs to the first space, tab
    or carriage return; a FASTQ record holds one sequence line; an id of
    4,096 bytes or more is a parse error. A record longer than max_len
    doubles the buffer but keeps the cap at max_len, as the JAX package
    does, and the reader has by then consumed its head: such a record is
    skipped."""
    lib = load_library()
    handle = lib.cf_reader_open(path.encode())
    if not handle:
        raise FileNotFoundError(path)
    codes = np.empty(max_len, dtype=np.int8)
    id_buf = ctypes.create_string_buffer(4096)
    try:
        while True:
            n = lib.cf_reader_next(handle, codes.ctypes.data, max_len,
                                   id_buf, 4096)
            if n == -1:
                return
            if n == -2:
                codes = np.empty(codes.size * 2, dtype=np.int8)
                continue
            if n < 0:
                raise RuntimeError(f"parse error in {path}")
            yield id_buf.value.decode("ascii"), codes[:n].copy()
    finally:
        lib.cf_reader_close(handle)


def native_pack2bit(codes: np.ndarray, lens: Optional[np.ndarray] = None):
    """One-scan 2-bit packer (`cf_pack2bit`): (B, L) int8 codes ->
    (packed (B, L/4) uint8, n_mask (B, L/8) uint8 or None), the contract
    of `ops/fused_recruit.pack_2bit`. None where L is not a multiple
    of 8."""
    lib = load_library()
    B, L = codes.shape
    if L % 8:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    packed = np.empty((B, L // 4), dtype=np.uint8)
    n_mask = np.empty((B, L // 8), dtype=np.uint8)
    lens_ptr = None
    if lens is not None:
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        lens_ptr = lens.ctypes.data
    any_n = lib.cf_pack2bit(codes.ctypes.data, B, L, lens_ptr,
                            packed.ctypes.data, n_mask.ctypes.data)
    return packed, (n_mask if any_n else None)


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
