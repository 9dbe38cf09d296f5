"""De novo unit extraction on the port (`stages/unit_extraction.py`)
against the JAX package's, on the JAX package's own cases
(tests/test_tools_and_compat.py's period recovery, tests/test_clis.py's
CLI): every step's output, the clusters and the CLI's files are equal,
the plot helper writes its PDFs (and returns False without matplotlib),
and the module runs with jax unimportable. Both native libraries are
built first: the polish aligns through them."""

import os
import subprocess
import sys

import numpy as np
import pytest

from centroflye_tpu import native as jnative
from centroflye_tpu.io import write_seqs
from centroflye_tpu.pipeline.simulate import add_read_noise, gen_random_seq
from centroflye_tpu.stages import unit_extraction as jue

from centroflye_tpu_torch import native as tnative
from centroflye_tpu_torch.stages import unit_extraction as tue

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert jnative.load_native(build=True) is not None, \
        "the JAX package's libcfnative.so did not build"
    assert tnative.load_library() is not None


def _tandem_read(seed, unit_len=180, copies=12, noise=0.03):
    rng = np.random.default_rng(seed)
    unit = gen_random_seq(rng, unit_len)
    return unit, "".join(add_read_noise(rng, unit, noise)
                         for _ in range(copies))


@pytest.mark.parametrize("seed", [17, 3, 8])
def test_extract_units_equal(seed):
    """tests/test_tools_and_compat.py's case (rng 17, a 180-bp unit x 12
    at 3% noise) and two more seeds: period, hook, splits and consensus
    equal, and the consensus shares most k-mers with the unit."""
    unit, read = _tandem_read(seed)
    conv = tue.get_convolution(read)
    assert conv == jue.get_convolution(read)
    period = tue.get_period_info(conv)
    assert period == jue.get_period_info(conv)
    assert tue.find_hook(read, period) == jue.find_hook(read, period)
    hook = tue.find_hook(read, period)
    assert tue.split_at_hook(read, hook) == jue.split_at_hook(read, hook)
    got = tue.extract_units_from_read(read, bin_size=50)
    want = jue.extract_units_from_read(read, bin_size=50)
    assert (got.period_range, got.hook, got.units, got.consensus) == \
        (want.period_range, want.hook, want.units, want.consensus)
    lo, hi = got.period_range
    assert lo <= 180 < hi + 50
    k = 15
    unit_kmers = {unit[i:i + k] for i in range(len(unit) - k + 1)}
    hits = sum(got.consensus[i:i + k] in unit_kmers
               for i in range(len(got.consensus) - k + 1))
    assert hits > 0.5 * (len(got.consensus) - k + 1)


@pytest.mark.parametrize("read", ["", "ACGT" * 10,
                                  gen_random_seq(np.random.default_rng(1),
                                                 2000)])
def test_extract_units_without_a_period_equal(read):
    got = tue.extract_units_from_read(read)
    want = jue.extract_units_from_read(read)
    assert (got.period_range, got.hook, got.units, got.consensus) == \
        (want.period_range, want.hook, want.units, want.consensus)
    assert got.consensus is None


def test_cluster_units_equal():
    per_read = {}
    for i, (ul, seed) in enumerate([(180, 4), (180, 5), (260, 6), (262, 7),
                                    (400, 9)]):
        _, read = _tandem_read(seed, unit_len=ul, copies=10)
        res = tue.extract_units_from_read(read)
        if res.consensus:
            per_read[f"r{i}"] = res.consensus
    assert len(per_read) >= 4
    got = tue.cluster_units(per_read)
    assert got == jue.cluster_units(per_read)
    assert len(got) >= 2


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if not n.endswith(".pdf"):
                with open(os.path.join(d, n), "rb") as f:
                    out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def test_cli_writes_the_jax_files(tmp_path):
    """tests/test_clis.py's case: two reads of a 150-bp unit x 10 at 3%
    noise, with --cluster and --plot-dir."""
    rng = np.random.default_rng(17)
    unit = gen_random_seq(rng, 150)
    reads = {f"r{i}": add_read_noise(rng, unit * 10, 0.03)
             for i in range(2)}
    reads_fn = str(tmp_path / "reads.fasta")
    write_seqs(reads_fn, reads)
    for tag, mod in (("port", tue), ("jax", jue)):
        os.makedirs(tmp_path / tag)
        mod.main(["--reads", reads_fn, "--output",
                  str(tmp_path / tag / "units.fasta"), "--cluster",
                  "--plot-dir", str(tmp_path / tag / "plots")])
    files = _files(str(tmp_path / "port"))
    assert files == _files(str(tmp_path / "jax"))
    assert {"units.fasta", "units.fasta.clusters.fasta"} <= set(files)
    pdfs = sorted(os.listdir(tmp_path / "port" / "plots"))
    assert pdfs == sorted(os.listdir(tmp_path / "jax" / "plots")) == \
        [f"r{i}_period.pdf" for i in range(2)]


def test_plot_without_matplotlib(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    fn = str(tmp_path / "p.pdf")
    assert tue.plot_period_histogram({180: 3}, fn, (150, 250)) is False
    assert jue.plot_period_histogram({180: 3}, fn, (150, 250)) is False
    assert not os.path.exists(fn)


def test_unit_extraction_runs_with_jax_blocked(tmp_path):
    _, read = _tandem_read(17)
    fn = str(tmp_path / "reads.fasta")
    write_seqs(fn, {"r0": read, "r1": read})
    code = f"""
import sys
sys.modules["jax"] = None
from centroflye_tpu_torch.stages import unit_extraction as ue
ue.main(["--reads", {fn!r}, "--output", {str(tmp_path / "u.fasta")!r},
         "--cluster"])
bad = sorted(m for m in sys.modules if m.split(".")[0] == "centroflye_tpu")
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
    assert os.path.exists(tmp_path / "u.fasta.clusters.fasta")
