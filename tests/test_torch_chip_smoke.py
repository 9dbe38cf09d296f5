"""chip_smoke.py on the CPU: its read mix is bench.py's, bit for bit;
without a CUDA card it fails and prints no result; its stage-2-4 world
keeps its records when the boundary reads join it; and the host parts of
its decomposition and placement phases hold at a small size."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

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


def _world_digest(world):
    h = hashlib.sha256()
    for r, rec in world.dec.records.items():
        h.update(f"{r} {rec.r_len} {rec.strand} {rec.r_st} {rec.r_en} "
                 f"{rec.seq} {rec.bounds.tolist()}\n".encode())
    h.update(world.arr.tobytes())
    return h.hexdigest()


# make_world's array and records before the boundary reads joined it
WORLD_DIGESTS = {
    10: "908e3138e4f50593e8bdd5adb7f2ee46ec8f838da6c0c87f3f31b4c5e6e3c9f7",
    12: "6660fec4c7cd66afd8965246507f0be2506c02b6738d5cce86db69908f98cdf9"}


@pytest.fixture(scope="module")
def dxz1():
    import chip_smoke
    from centroflye_tpu_torch.io.fasta import read_seq
    return read_seq(chip_smoke.UNIT_FASTA)


@pytest.mark.parametrize("n_units", sorted(WORLD_DIGESTS))
def test_world_records_unchanged_by_boundary_reads(dxz1, n_units):
    import chip_smoke
    world = chip_smoke.make_world(dxz1, n_units)
    assert _world_digest(world) == WORLD_DIGESTS[n_units]
    m = len(dxz1)
    n = chip_smoke.BOUNDARY_READS
    ids = [r for r, _ in world.boundary]
    assert ids[:2 * n] == [f"pre{j:02d}" for j in range(n)] + \
        [f"suf{j:02d}" for j in range(n)]
    assert {r[:3] for r in ids[2 * n:]} == {"lft", "rgt"}
    for r_id, seq in world.boundary:
        b = world.boundary_bounds[r_id]
        assert len(b) - 1 >= chip_smoke.MIN_RECORD_LEN // m
        assert (np.diff(b) > 0.9 * m).all() and (np.diff(b) < 1.1 * m).all()
        flank = b[0] if r_id[0] in "pl" else len(seq) - b[-1]
        if r_id[0] in "ps":
            assert 4 <= len(b) - 1 <= 9
            assert 0.9 * 52_000 < flank < 1.1 * 90_000
        assert 0 <= flank < 1.1 * chip_smoke.FLANK_BP
        assert world.u0[r_id] == (0 if r_id[0] in "pl"
                                  else n_units - (len(b) - 1))
    assert set(world.u0) == set(world.dec.records) | set(world.boundary_bounds)


def test_decomposition_phase_checks_hold(dxz1, capsys):
    """Phase decomposition on a 10-unit world: the native library builds,
    the shaped boundary reads classify 24 / 0 / 24, every read over the
    ends gives a record, and the sample's checks pass (it needs no
    card)."""
    import chip_smoke
    world = chip_smoke.make_world(dxz1, 10)
    bdec = chip_smoke.phase_decomposition(dxz1, world)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "decomposition"
    shaped = line["boundary"]["shaped"]
    assert (shaped["prefix"], shaped["internal"], shaped["suffix"]) == \
        (24, 0, 24)
    crossing = line["boundary"]["flank_crossing"]
    assert crossing["records"] == crossing["reads"] > 0
    assert line["sample"]["records"] == len(world.dec.records)
    assert set(bdec.records) == set(world.boundary_bounds)


@pytest.mark.parametrize("max_vocab", [1 << 17, 0])
def test_scoring_calls_recorded_and_replayed(monkeypatch, max_vocab):
    """The placement phase's scoring record and replay, on the CPU with
    the card's synchronisation stubbed: through either scorer, every
    call is recorded with its scores, and the replay against the other
    scorer and the CPU passes; a wrong score fails it."""
    import torch

    import chip_smoke
    from centroflye_tpu_torch.config import PlacerConfig
    from centroflye_tpu_torch.stages.kmer_cloud import ReadClouds
    from centroflye_tpu_torch.stages.placement_fast import (ArrayContig,
                                                            FastPlacer)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(FastPlacer, "_MATMUL_MAX_VOCAB", max_vocab)
    rng = np.random.default_rng(4)

    def read(r_id, n):
        return ReadClouds(r_id, [np.sort(rng.choice(40, int(rng.integers(
            2, 6)), replace=False)).astype(np.int64) for _ in range(n)])

    contig = ArrayContig(2)
    for i in range(3):
        contig.add_read(read(f"p{i}", 10), 0)
    clouds = {f"r{i}": read(f"r{i}", int(rng.integers(2, 7)))
              for i in range(9)}
    calls = []
    with chip_smoke.recorded_scoring(calls):
        FastPlacer(contig, sorted(clouds), clouds,
                   PlacerConfig(min_unit=1, min_inters=2, min_prop=1),
                   device="cpu").run()
    assert [c["path"] for c in calls] == \
        ["matmul" if max_vocab else "popcount"]
    shapes = chip_smoke.check_scoring_calls(calls, "cpu")
    assert shapes[0][:2] == [9, 6] and calls[0]["s1"].max() > 0
    calls[0]["s1"] = calls[0]["s1"] + 1
    with pytest.raises(SystemExit, match="differ"):
        chip_smoke.check_scoring_calls(calls, "cpu")
