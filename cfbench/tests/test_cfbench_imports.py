"""The no-JAX guard: no module of the benchmark imports `jax`, `jaxlib`,
`flax` or the JAX package (top-level names compared whole: the port's
name begins with the JAX package's), the plain references import nothing
of the port, and run.py refuses those imports before it imports
anything."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import pytest

from cfbench.lib import spec

BLOCKED = {"jax", "jaxlib", "flax", "centroflye_tpu"}
FILES = sorted(glob.glob(os.path.join(spec.HERE, "**", "*.py"),
                         recursive=True))


def top_level_imports(fn: str) -> set:
    out = set()
    for node in ast.walk(ast.parse(open(fn).read(), fn)):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("fn", FILES, ids=lambda f: os.path.relpath(
    f, spec.HERE))
def test_no_jax_import(fn):
    assert not top_level_imports(fn) & BLOCKED


@pytest.mark.parametrize("fn", sorted(glob.glob(spec.path("reference",
                                                          "*.py"))))
def test_reference_imports_nothing_of_the_port(fn):
    assert top_level_imports(fn) <= {"__future__", "numpy", "torch"}


def test_run_blocks_jax():
    code = ("import cfbench.run as r\n"
            "for name in ('jax', 'jax.numpy', 'centroflye_tpu', "
            "'centroflye_tpu.ops'):\n"
            "    try:\n"
            "        __import__(name)\n"
            "    except ModuleNotFoundError:\n"
            "        continue\n"
            "    raise SystemExit('imported ' + name)\n"
            "import centroflye_tpu_torch\n"
            "assert not r.loaded_blocked(), r.loaded_blocked()\n")
    got = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr[-2000:]


def test_no_card_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and cfbench/, or on
    a machine without a card, a run exits with another code than 0 and
    prints no result."""
    import shutil
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "cfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = subprocess.run(
        [sys.executable, "cfbench/run.py", "--workload", "cenx.recruit.rel2",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
