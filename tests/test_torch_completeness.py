"""The port is complete and self-contained. Every module of the JAX
package has its counterpart in the port with every top-level name, but
for the names left out on purpose (below, and in ROADMAP.md Queue 1);
and no file of the port, nor `chip_smoke.py`, imports jax or the JAX
package or names that package's directory."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT = "centroflye_tpu", "centroflye_tpu_torch"

# JAX-package names with no counterpart of that name in the port
LEFT_OUT = {
    # the Pallas kernels: ops/myers_cuda.py and csrc/ hold their ports
    "ops/myers_pallas_v3.py": None,
    # JAX-only: the persistent compilation cache, the profiler span
    "__init__.py": {"_enable_compilation_cache", "_os"},
    "utils/logging_utils.py": {"jax_profile"},
    # jitted helpers of the JAX routes; the port does their work in
    # other forms: the blocked sweep fork and the bounded edge
    # compaction (one keep.nonzero() gather, `_kept_edges`), its sorted
    # pair and table-filter cores, the rare pass's stacked pair, the
    # seq-par tier's cached jit step, the scan's full-word constant
    "stages/distance_graph.py": {
        "_SENT", "_compact_edges_full_sorted", "_compact_edges_small",
        "_filter_table_device", "_pairs_from_buckets_core",
        "_sorted_pairs_blocked", "_sorted_pairs_blocked_core",
        "_sorted_pairs_core"},
    "stages/rare_kmers.py": {"_stack2"},
    "parallel/seq_parallel.py": {"_STEP_CACHE", "_build_step"},
    "ops/myers.py": {"_FULL"},
    # the library-keyed fallbacks: the port's library builds
    # (`native.build`) and loads (`native.load_library`) or raises
    "stages/polisher.py": {"_DEVICE_NW_MAX", "_device_nw"},
    "native/__init__.py": {"_LIB_PATH", "_lib", "build_native",
                           "load_native", "native_available"},
}


def _names(fn):
    with open(fn) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and \
                fn.endswith("__init__.py"):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.startswith("__")}


def _modules():
    root = os.path.join(REPO, JAX_PKG)
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), root)


@pytest.mark.parametrize("rel", sorted(_modules()))
def test_port_has_every_name(rel):
    port = os.path.join(REPO, PORT, rel)
    left_out = LEFT_OUT.get(rel, set())
    if left_out is None:
        assert not os.path.exists(port)
        return
    missing = _names(os.path.join(REPO, JAX_PKG, rel)) - _names(port)
    assert missing == left_out


def _port_files():
    yield os.path.join(REPO, "chip_smoke.py")
    for d, _, files in os.walk(os.path.join(REPO, PORT)):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("fn", sorted(os.path.relpath(f, REPO)
                                      for f in _port_files()))
def test_port_file_stands_alone(fn):
    """No import of jax or the JAX package, and no path built from the
    JAX package's directory name (the `*_REPLACES` strings that name a
    kernel's origin, "centroflye_tpu/ops/...", are text, not paths)."""
    with open(os.path.join(REPO, fn)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module or ""]
        else:
            mods = []
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", JAX_PKG), (fn, mod)
        if isinstance(node, ast.Constant):
            assert node.value != JAX_PKG, fn
