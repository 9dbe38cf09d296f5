"""The port's simulator (`pipeline/simulate.py`) against the JAX package's,
on the same `np.random.Generator` streams: clustered noise and its
measured uniform-equivalent error, sampled and tiling read sets, the
simulation's files, the read-id parser and the CLI's files are equal;
and the port's module runs with jax unimportable."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from centroflye_tpu.io import write_seqs
from centroflye_tpu.pipeline import simulate as jsim

from centroflye_tpu_torch.pipeline import simulate as tsim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(fn_name, seed, *args, **kw):
    """fn_name of each module on its own generator from `seed`; the
    generators must also end in the same state."""
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = getattr(jsim, fn_name)(rj, *args, **kw)
    got = getattr(tsim, fn_name)(rt, *args, **kw)
    assert rj.random() == rt.random()
    return got, want


SEQS = ["", "A", "AAAAAAAACCCGT", "ACGT" * 50 + "T" * 40 + "GA" * 30,
        "".join("ACGT"[i] for i in np.random.default_rng(1).integers(
            0, 4, 3000))]


@pytest.mark.parametrize("rate", [0.0, 0.02, 0.1, 0.3])
@pytest.mark.parametrize("seq", SEQS)
def test_clustered_noise_equal(seq, rate):
    got, want = _both("add_read_noise_clustered", 5, seq, rate)
    assert got == want
    if rate == 0 or not seq:
        assert got == seq


def test_clustered_effective_error_equal(monkeypatch):
    monkeypatch.setattr(tsim, "_EFF_CACHE", {})
    got = tsim.clustered_effective_error(0.10)
    assert got == jsim.clustered_effective_error(0.10)
    assert 0.0 < got < 0.10
    assert tsim._EFF_CACHE == {(0.1, 19): got}
    assert tsim.clustered_effective_error(0.1 + 1e-9) == got  # cached


def _fields(reads):
    return [dataclasses.astuple(r) for r in reads]


@pytest.mark.parametrize("both_strands", [True, False])
@pytest.mark.parametrize("error_rate", [0.0, 0.08])
def test_read_sets_equal(both_strands, error_rate):
    genome = tsim.gen_random_seq(np.random.default_rng(2), 5000)
    got, want = _both("simulate_reads", 3, genome, 25, 900, 300,
                      error_rate, min_len=200, both_strands=both_strands)
    assert _fields(got) == _fields(want)
    assert {r.strand for r in got} == ({"+", "-"} if both_strands
                                       else {"+"})
    got, want = _both("simulate_tiling_reads", 4, genome, 700, 300,
                      error_rate, both_strands=both_strands)
    assert _fields(got) == _fields(want)
    assert got[0].start == 0 and got[-1].end <= len(genome)
    assert type(got[0]).__name__ == "SimulatedRead"


def _files(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


def test_write_simulation_equal(tmp_path):
    sim, _ = _both("simulate_tandem_repeat", 6, "ACGTTGCAAC" * 12, 20,
                   0.05, flank_len=300)
    tsim.write_simulation(sim, str(tmp_path / "port"))
    jsim.write_simulation(sim, str(tmp_path / "jax"))
    files = _files(str(tmp_path / "port"))
    assert files == _files(str(tmp_path / "jax"))
    assert set(files) == {"tandem_repeat.fasta",
                          "left_flanked_tandem_repeat.fasta",
                          "flanked_tandem_repeat.fasta", "all_muts.json",
                          "simulation.log"}


@pytest.mark.parametrize("r_id", [
    "sim_read_00012_+", "tile_read_00003_-", "sim_read_x_+", "sim_read_1",
    "r1", "sim_reads_00012_+", "", "a_read_7_+"])
def test_parse_sim_read_id_equal(r_id):
    assert tsim.parse_sim_read_id(r_id) == jsim.parse_sim_read_id(r_id)


@pytest.mark.parametrize("extra", [
    ["--seed", "3"],
    ["--seed", "4", "--n-reads", "6", "--read-len-mean", "1500",
     "--read-len-std", "400", "--error-rate", "0.05"],
    ["--seed", "5", "--unit", "UNIT", "--n-reads", "3",
     "--read-len-mean", "800", "--read-len-std", "100"],
])
def test_cli_files_equal(tmp_path, extra):
    unit_fn = str(tmp_path / "unit.fasta")
    write_seqs(unit_fn, {"u": "ACGTACGGTCA" * 9})
    extra = [unit_fn if a == "UNIT" else a for a in extra]
    base = ["--multiplicity", "12", "--div-rate", "0.02", "--unit-len",
            "90", "--flank-len", "500"] + extra
    tsim.main(base + ["-o", str(tmp_path / "port")])
    jsim.main(base + ["-o", str(tmp_path / "jax")])
    files = _files(str(tmp_path / "port"))
    assert files == _files(str(tmp_path / "jax"))
    assert ("reads.fasta" in files) == ("--n-reads" in extra)


def test_simulator_runs_with_jax_blocked(tmp_path):
    code = f"""
import sys
sys.modules["jax"] = None
import numpy as np
from centroflye_tpu_torch.pipeline import simulate as s
s.main(["--multiplicity", "5", "--div-rate", "0.01", "--unit-len", "60",
        "--flank-len", "100", "--seed", "1", "--n-reads", "2",
        "--read-len-mean", "300", "--read-len-std", "50",
        "-o", {str(tmp_path)!r}])
rng = np.random.default_rng(0)
assert s.add_read_noise_clustered(rng, "ACGT" * 30, 0.1)
assert s.parse_sim_read_id("sim_read_00001_+")["index"] == 1
bad = sorted(m for m in sys.modules if m.split(".")[0] == "centroflye_tpu")
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"
    assert os.path.exists(tmp_path / "reads.fasta")
