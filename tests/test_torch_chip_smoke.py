"""chip_smoke.py on the CPU: its read mix is bench.py's, bit for bit;
without a CUDA card it fails and prints no result; its stage-2-4 world
keeps its records when the boundary reads join it; and the host parts of
its decomposition and placement phases, main_path's check of the two
fills and phase cli (FASTA and gzipped FASTQ) hold at a small size."""

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


def test_hold_fused_k1_takes_a_mixed_full_batch(monkeypatch):
    """hold_fused_k1 on CPU tensors (K1's plain route) at a 512-column
    segment: of a short batch, a full batch of tandem rows only and a
    full batch with rows within and past the threshold, it holds the
    last against the plain version, on every row."""
    import torch

    import chip_smoke as cs
    monkeypatch.setattr(cs, "PIPELINE_SEG_LEN", 512)
    monkeypatch.setattr(cs, "time_cuda", lambda fn, reps: fn() and 0.0)
    monkeypatch.setattr(cs, "timed_plain", lambda fn: (fn(), 0.0))
    rng = np.random.default_rng(3)
    m, L, B = 40, 512, 16
    unit = rng.integers(0, 4, m).astype(np.int8)

    def batch(lens_cap, tandem_only):
        pf, pr, text_t, lens = cs.k1_case(rng, unit, m, L, B, "cpu")
        codes = text_t.t().contiguous()
        if tandem_only:
            codes[:] = torch.from_numpy(np.tile(unit, L // m + 1)[:L])
            lens[:] = L
        return pf, pr, codes, lens.clamp(max=lens_cap)
    captured = [batch(L - 1, False), batch(L, True), batch(L, False)]
    fields, instance = cs.hold_fused_k1(captured, m, 1e13, 10,
                                        "cenx_pipeline")
    assert list(instance) == [f"{B}x512 cenx_pipeline fused step"]
    assert fields["max_abs_err"] == 0 and fields["rows"] == B
    assert fields["m"] == m and fields["mixed_band"]
    assert fields["sum_lens"] == int(captured[2][3].sum())
    assert 0 < fields["rows_in_band"] < B
    assert fields["batches_captured"] == 3


def _small_mix(seed=6, n=24):
    """A 150-bp unit and a mix of tandem reads (10% noise, both strands)
    and background reads of 300-2,500 bases."""
    from centroflye_tpu_torch.io.encoding import revcomp_str
    from centroflye_tpu_torch.pipeline.simulate import (add_read_noise,
                                                        gen_random_seq)
    rng = np.random.default_rng(seed)
    unit = gen_random_seq(rng, 150)
    reads = []
    for i in range(n):
        L = int(rng.integers(300, 2500))
        if i % 4 == 0:
            src = unit if i % 8 else revcomp_str(unit)
            seq = add_read_noise(rng, src * (L // 150 + 1), 0.10)[:L]
        else:
            seq = gen_random_seq(rng, L)
        reads.append((f"r{i:05d}", seq))
    return unit, reads


def _small_config(threshold=40):
    from centroflye_tpu_torch.config import RecruitmentConfig
    return RecruitmentConfig(threshold=threshold, batch_size=16)


def test_hold_fills_on_the_cpu(monkeypatch):
    """main_path's fill check on CPU tensors: the numpy-fill runs and the
    second native run equal the counted native run read by read; a
    changed distance fails it; both fills' host seconds are measured."""
    import torch

    import chip_smoke as cs
    from centroflye_tpu_torch.stages.recruitment import RecruitmentEngine
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    unit, reads = _small_mix()
    cfg = _small_config()
    results = list(RecruitmentEngine(unit, cfg, seg_len=512,
                                     device="cpu").run(reads))
    assert 0 < sum(r.recruited for r in results) < len(reads)
    runs, fills = cs.hold_fills(unit, cfg, reads, results, "cpu",
                                seg_len=512)
    assert [len(runs[f]) for f in (False, True)] == [2, 1]
    assert all(len(v) == 2 and min(v) > 0 for v in fills.values())
    results[5].dist_rc += 1
    with pytest.raises(SystemExit, match="numpy fill differs"):
        cs.hold_fills(unit, cfg, reads, results, "cpu", seg_len=512)


def test_cli_phase_holds_on_the_cpu(monkeypatch, tmp_path, capsys):
    """Phase cli at a small size on the CPU: recruit_file on the FASTA
    writes the reads recruited in memory, and on the same reads as
    gzipped FASTQ with descriptions, lowercase stretches and IUPAC
    letters the FASTA run's file in the native reader's form; a
    recruited set that is not the engine's fails it."""
    import chip_smoke as cs
    from centroflye_tpu_torch.io.fasta import write_seqs
    from centroflye_tpu_torch.stages.recruitment import RecruitmentEngine
    unit, reads = _small_mix(seed=8, n=40)
    unit_fn = str(tmp_path / "unit.fasta")
    write_seqs(unit_fn, {"unit": unit})
    for name, value in (("UNIT_FASTA", unit_fn), ("THRESHOLD", 40),
                        ("BATCH_SIZE", 16), ("SEG_LEN", 512),
                        ("CLI_READS", 30)):
        monkeypatch.setattr(cs, name, value)
    recruited = {r.r_id for r in RecruitmentEngine(
        unit, _small_config(), seg_len=512, device="cpu").run(reads)
        if r.recruited}
    cs.phase_cli(reads, recruited, "cpu")
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "cli" and line["fastq_gz_equal"]
    assert line["recruited"] == len({r for r, _ in reads[:30]} & recruited)
    assert line["recruited_with_iupac"] > 0
    with pytest.raises(SystemExit, match="CLI output"):
        cs.phase_cli(reads, recruited | {"r00001"}, "cpu")


@pytest.mark.parametrize("m", [40, 90])
def test_plain_both_strands_is_the_two_strand_plain(m):
    """plain_both_strands (both strands as one plain call of 2B rows with
    per-row queries), which hold_fused_k1 takes as K1's reference, gives
    myers_hw_2strand_plain's four outputs on a mixed batch: ragged lens,
    N runs, tandem rows on both strands, random rows."""
    import torch

    import chip_smoke as cs
    from centroflye_tpu_torch.ops.myers_cuda import myers_hw_2strand_plain
    rng = np.random.default_rng(m)
    unit = rng.integers(0, 4, m).astype(np.int8)
    pf, pr, text_t, lens = cs.k1_case(rng, unit, m, 600, 24, "cpu")
    want = myers_hw_2strand_plain(pf, pr, text_t, lens, m=m)
    got = cs.plain_both_strands(pf, pr, text_t, lens, m=m)
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key].long(), want[key].long()), key
    d = torch.minimum(want["dist_f"], want["dist_r"])
    assert int(d.min()) < m // 4 and int(d.max()) > m // 2


def test_hold_tier_k5_holds_a_last_stage_launch(monkeypatch):
    """captured_seqpar_k5 keeps the sequence-parallel tier's K5 launches
    (here K5's plain route, on a 4-device CPU mesh), and hold_tier_k5
    holds the last-stage one whose row lies within the threshold and
    ends inside the chunk (not the random row's, nor the empty row's)
    against the plain version on the whole carried state; a state that
    differs in one VP bit fails it."""
    import chip_smoke as cs
    from centroflye_tpu_torch.ops import myers_cuda
    from centroflye_tpu_torch.ops.myers import build_peq, words_tensor
    from centroflye_tpu_torch.parallel import seq_parallel as sp
    monkeypatch.setattr(cs, "THRESHOLD", 6)
    monkeypatch.setattr(cs, "time_cuda", lambda fn, reps: fn() and 0.0)
    rng = np.random.default_rng(4)
    m, L = 40, 1200
    unit = rng.integers(0, 4, m).astype(np.int8)
    text = rng.integers(0, 4, (3, L)).astype(np.int8)
    text[0] = np.tile(unit, L // m)[:L]
    flip = rng.random(L) < 0.03
    text[0, flip] = rng.integers(0, 4, int(flip.sum()))
    lens = np.array([L - 100, L, 0], np.int32)
    mesh = sp.make_seq_mesh(4, devices=["cpu"] * 4)
    peq = words_tensor(build_peq(unit), "cpu")
    with cs.captured_seqpar_k5() as captured:
        out = sp.myers_distance_seqparallel(peq, text, lens, m=m,
                                            mesh=mesh)
    assert len(captured) == 3 * 4
    assert sp.myers_carry is myers_cuda.myers_carry
    assert int(out["dist"][0]) <= 6
    fields = cs.hold_tier_k5(captured, 1e13)
    assert fields["c0"] == 3 * L // 4 and fields["chunk"] == L // 4
    assert fields["rows"] == 1 and fields["lens"] == [L - 100]
    assert fields["max_abs_err"] == 0 and fields["mode"] == "HW"
    assert fields["best"] == [int(out["dist"][0])]
    for (_, _, _, _, c0), _, state in captured:
        if c0 == 3 * L // 4:
            state.vp[0, 0] ^= 1
    with pytest.raises(SystemExit, match="K5 != its plain version"):
        cs.hold_tier_k5(captured, 1e13)


def test_cen6_world_is_the_bench_shape():
    """chip_smoke's copies of benchmarks/bench_mono_cen6.py's array and
    read-length mix give the bench's draws, bit for bit; the world's
    reads lie on the array (a '+' read's source, through `add_noise`'s
    cum, covers its monomers)."""
    sys.path.insert(0, os.path.join(REPO, "benchmarks"))
    import bench_mono_cen6 as bench
    import chip_smoke as cs
    for seed in (0, 23):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        assert np.array_equal(cs.build_symbol_genome(a, 40, 18),
                              bench.build_symbol_genome(b, 40))
        assert np.array_equal(cs.cen6_length_mix(a, 500),
                              bench.read_length_mix(b, 500))
    world = cs.cen6_world(n_hor=4, coverage=30)
    assert len(world.syms) == 72 and world.bounds[-1] == world.arr.size
    assert world.truth and set(world.truth) < {r for r, _ in world.reads}
    for r_id, (a, cum) in world.truth.items():
        assert 0 <= a < world.arr.size and cum[-1] == len(dict(
            world.reads)[r_id])


def test_cen6_checks_on_an_exact_decomposition():
    """call_accuracy, find_run and tree_digest on the CPU: two
    noise-free reads of a 3-HOR world decomposed by the port's
    decomposer score every call right; a scaffold that is a slice of the
    array is found where it starts, one that is not gives -1; the tree
    digest moves with a file's bytes."""
    import tempfile

    import chip_smoke as cs
    from centroflye_tpu_torch.mono.string_decomposer import (
        decompose_to_monostrings)
    world = cs.cen6_world(n_hor=3, coverage=1)
    reads = [("p0", cs.decode(world.arr[:4000])),
             ("p1", cs.decode(world.arr[1000:5000]))]
    world.truth = {r: (a, np.arange(4001)) for r, a in
                   (("p0", 0), ("p1", 1000))}
    sd = decompose_to_monostrings(world.monomers, reads, device="cpu")
    calls, correct, flipped = cs.call_accuracy(world, sd)
    assert calls > 40 and correct == calls and flipped == 0
    assert cs.find_run(world.syms, world.syms[5:30]) == 5
    assert cs.find_run(world.syms, np.array([99, 98], np.int16)) == -1
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "a.dot"), "w") as f:
            f.write("digraph {}\n")
        first = cs.tree_digest(d)
        assert cs.tree_digest(d) == first
        with open(os.path.join(d, "a.dot"), "a") as f:
            f.write(" ")
        assert cs.tree_digest(d) != first
