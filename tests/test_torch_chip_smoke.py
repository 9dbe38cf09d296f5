"""chip_smoke.py on the CPU: its read mix is bench.py's, bit for bit, and
without a CUDA card it fails and prints no result."""

import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_read_mix_is_bench_mix(monkeypatch):
    import bench
    import chip_smoke
    from centroflye_tpu.pipeline.simulate import gen_random_seq
    unit = gen_random_seq(np.random.default_rng(2), 700)
    monkeypatch.setattr(bench, "N_READS", 150)
    reads, cen = chip_smoke.make_reads(unit, n_reads=150)
    assert reads == bench.make_reads(unit)
    assert cen == {f"r{i:05d}" for i in range(0, 150, 50)}


def test_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "cuda" in proc.stderr.lower()
