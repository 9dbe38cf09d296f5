"""SASS count of the column loop of the port's HW Myers kernel (K1 and K2,
`centroflye_tpu_torch/csrc/myers_hw_2strand.cu`).

    python3 tools/probe_myers_wavefront.py [--before OLD.cu] [--sass-dir DIR]

Builds the port's kernels, disassembles them with cuobjdump and prints,
one JSON line each, the instructions of the innermost loop of DXZ1's
instances (m = 2055, W = 65: G = 8 with 9 words a lane, G = 32 with 3),
per loop and per column, with the opcodes. With --before, the same for
OLD.cu, an earlier version of the source whose kernel is
`myers_hw_kernel<3, ...>` (one column a loop). With --sass-dir, each
loop's SASS is written there. Needs nvcc and cuobjdump; no card.
"""

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from centroflye_tpu_torch.ops import _build  # noqa: E402

UNROLL = 4       # kUnroll of the source: columns in one loop body
AFTER = r"myers_hw_wavefrontILi(8ELi9|32ELi3)E"
BEFORE = r"myers_hw_kernelILi3E"
INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")


def cuobjdump():
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        raise SystemExit("probe: cuobjdump not found")
    return tool


def sass_loops(path, pattern, dump_dir=None):
    """(kernel, loop instructions, opcode counts) of the innermost loop
    with the longest body in each kernel of `path` matching `pattern`;
    with `dump_dir`, each loop's SASS goes to a file there."""
    text = subprocess.run([cuobjdump(), "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    found = []
    for chunk in text.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if not re.search(pattern, name):
            continue
        ins = INSN.findall(chunk)
        addr = [int(a, 16) for a, _, _, _ in ins]
        loops = []                          # (first, last) of backward branches
        for k, (_, _, op, rest) in enumerate(ins):
            tgt = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and tgt and int(tgt.group(1), 16) <= addr[k]:
                loops.append((addr.index(int(tgt.group(1), 16)), k))
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                            for l2, h2 in loops)]
        if not inner:
            continue
        lo, hi = max(inner, key=lambda p: p[1] - p[0])
        ops = collections.Counter(op.split(".")[0]
                                  for _, _, op, _ in ins[lo:hi + 1])
        found.append((name, hi - lo + 1, dict(ops.most_common())))
        if dump_dir:
            os.makedirs(dump_dir, exist_ok=True)
            with open(os.path.join(dump_dir, f"{name[-60:]}.sass"), "w") as f:
                f.write("\n".join(f"{p}{op}{rest};"
                                   for _, p, op, rest in ins[lo:hi + 1]))
    return found


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--before", help="an earlier myers_hw_2strand.cu")
    ap.add_argument("--sass-dir", help="write each loop's SASS here")
    args = ap.parse_args()
    libs = {"after": (_build.build(), AFTER, UNROLL)}
    if args.before:
        lib = os.path.join(_build.BUILD_DIR, "probe_before.so")
        subprocess.run([_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
                        "-Xcompiler", "-fPIC", "-shared", "-o", lib,
                        args.before], check=True)
        libs["before"] = (lib, BEFORE, 1)
    for when, (lib, pattern, columns) in libs.items():
        for name, n, ops in sass_loops(lib, pattern, args.sass_dir):
            print(json.dumps({"sass": when, "kernel": name,
                              "loop_instructions": n,
                              "per_column": n / columns, "opcodes": ops}),
                  flush=True)


if __name__ == "__main__":
    main()
