"""The port's end-to-end runner (`python -m centroflye_tpu_torch.run_all_cenx`)
on the CPU: with jax unimportable it writes the files that
`CenXPipeline` writes for the same reads, unit (the port's own
data/DXZ1_rc.fasta) and coverage; it takes the JAX runner's arguments
(reads, outdir, coverage defaulting to 32, --distributed) and runs on
the card unless --device says otherwise; and a failed native build
raises."""

import os
import subprocess
import sys

import numpy as np
import pytest

from centroflye_tpu_torch import DATA_DIR, run_all_cenx
from centroflye_tpu_torch.config import CentroFlyeConfig
from centroflye_tpu_torch.io import read_seq, write_seqs
from centroflye_tpu_torch.io.encoding import revcomp_str
from centroflye_tpu_torch.pipeline import cenx
from centroflye_tpu_torch.pipeline.simulate import (add_read_noise,
                                                    gen_random_seq,
                                                    simulate_tandem_repeat)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            if n != "metrics.json":
                with open(os.path.join(d, n), "rb") as f:
                    out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


@pytest.fixture(scope="module")
def reads_fn(tmp_path_factory):
    """A 12-copy DXZ1 array in 6 kb flanks, tiled by 9 kb reads on both
    strands at 3% noise, and three background reads."""
    rng = np.random.default_rng(3)
    unit = read_seq(os.path.join(DATA_DIR, "DXZ1_rc.fasta"))
    g = simulate_tandem_repeat(rng, unit, mult=12, div_rate=0.01,
                               flank_len=6000).flanked_tr
    reads = {}
    for i, st in enumerate(range(0, len(g) - 9000, 1500)):
        seq = g[st:st + 9000]
        reads[f"r{i:03d}"] = add_read_noise(
            rng, revcomp_str(seq) if i % 3 == 1 else seq, 0.03)
    for b in range(3):
        reads[f"bg{b}"] = gen_random_seq(rng, 5000)
    fn = str(tmp_path_factory.mktemp("world") / "reads.fasta")
    write_seqs(fn, reads)
    return fn


def test_runner_writes_the_pipelines_files(reads_fn, tmp_path):
    code = """
import sys
sys.modules["jax"] = None
from centroflye_tpu_torch import run_all_cenx
run_all_cenx.main(sys.argv[1:])
bad = sorted(m for m in sys.modules if m.split(".")[0] == "centroflye_tpu")
assert not bad, bad
"""
    env = {k: v for k, v in os.environ.items() if k != "MASTER_ADDR"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code, reads_fn, str(tmp_path / "runner"), "6",
         "--distributed", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    unit = read_seq(os.path.join(DATA_DIR, "DXZ1_rc.fasta"))
    cenx.CenXPipeline(unit, CentroFlyeConfig(coverage=6),
                      str(tmp_path / "pipeline"), device="cpu").run(reads_fn)
    files = _files(str(tmp_path / "runner"))
    assert files == _files(str(tmp_path / "pipeline"))
    assert files["unit.fasta"].decode().split("\n")[1] == unit
    assert files["centromeric_reads.fasta"].count(b">") == 19


def test_runner_arguments(monkeypatch, tmp_path):
    """Positional reads, outdir and coverage (32 when left out), the unit
    from the port's data/, the card by default, and a native build that
    raises on failure."""
    seen = []

    class Pipe:
        def __init__(self, unit, config, outdir, **kw):
            seen.append((unit, config, outdir, kw))

        def run(self, reads):
            seen.append(reads)
            return "ACGT"

    monkeypatch.setattr(cenx, "CenXPipeline", Pipe)
    assert run_all_cenx.main(["r.fa", str(tmp_path)]) == "ACGT"
    unit, config, outdir, kw = seen[0]
    assert unit == read_seq(os.path.join(DATA_DIR, "DXZ1_rc.fasta"))
    assert config == CentroFlyeConfig(coverage=32)
    assert (outdir, kw, seen[1]) == (str(tmp_path), dict(
        device="cuda", distributed=False), "r.fa")
    run_all_cenx.main(["r.fa", str(tmp_path), "50", "--device", "cpu"])
    assert seen[2][1].coverage == 50 and seen[2][3]["device"] == "cpu"

    from centroflye_tpu_torch import native

    def fail():
        raise RuntimeError("g++ failed")
    monkeypatch.setattr(native, "build", fail)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        run_all_cenx.main(["r.fa", str(tmp_path)])
    assert len(seen) == 4
