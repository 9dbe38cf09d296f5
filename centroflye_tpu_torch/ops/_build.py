"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain
C interface, on first use, into `centroflye_tpu_torch/_build/`. The
library's name carries a hash of the sources and flags, so an edited
source builds anew. It is loaded with ctypes. A failed build raises:
nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c"]
LINK_FLAGS = [*ARCH, "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    "cf_myers_hw_2strand": [_P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _P],
    "cf_myers_hw_1strand": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "cf_myers_hw_banded": [_P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    "cf_myers_perrow": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "cf_myers_carry": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "cf_myers_hw_chunks": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "cf_seed_filter_compact": [_P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libcf_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns its path; nvcc's output (with -Xptxas -v register counts)
    is kept beside it as `<lib>.log`."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    tmp = f"{out}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(sources, objs)]
    log, failed = [], []
    for src, proc in zip(sources, procs):
        stdout, stderr = proc.communicate()
        log.append(f"== nvcc {os.path.basename(src)}\n{stdout}{stderr}")
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    if not failed:
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True)
        log.append(f"== nvcc link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    with open(out + ".log", "w") as f:
        f.write("".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           + "".join(log))
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C signatures."""
    lib = ctypes.CDLL(build())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
