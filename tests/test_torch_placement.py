"""Stage 4 of cenX on the port (`ops/scoring`, `stages/cloud_contig`,
`stages/placement_fast`, `stages/read_placer`, `pipeline/cenx.run_placement`
and `run_placement_validation`) against the JAX package, on
tests/test_read_placer.py's world (a 200-bp unit, 40 units): the same
placements and scores, both artifacts byte for byte, and each scorer and
contig equal to the JAX package's and to its own oracle. Every output is
an integer or a string: no tolerance."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from centroflye_tpu import config as jconfig
from centroflye_tpu import native as jnative
from centroflye_tpu.ops import scoring as jscoring
from centroflye_tpu.pipeline import cenx as jcenx
from centroflye_tpu.pipeline.simulate import (gen_random_seq,
                                              simulate_tandem_repeat)
from centroflye_tpu.stages import cloud_contig as jcc
from centroflye_tpu.stages import kmer_cloud as jkc
from centroflye_tpu.stages import placement_fast as jpf
from centroflye_tpu.stages import read_placer as jrp
from centroflye_tpu.stages.distance_graph import recruit_unique_kmers
from centroflye_tpu.stages.rare_kmers import get_rare_kmers
from centroflye_tpu.stages.unit_decomposition import UnitDecomposer

from centroflye_tpu_torch import config as tconfig
from centroflye_tpu_torch import native as tnative
from centroflye_tpu_torch.ops import scoring as tscoring
from centroflye_tpu_torch.ops.myers import words_tensor
from centroflye_tpu_torch.pipeline import cenx as tcenx
from centroflye_tpu_torch.stages import cloud_contig as tcc
from centroflye_tpu_torch.stages import kmer_cloud as tkc
from centroflye_tpu_torch.stages import placement_fast as tpf
from centroflye_tpu_torch.stages import read_placer as trp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 13
UNIT = 200
MULT = 40
FLANK = 6000
PLACER = dict(min_cloud_kmer_freq=2, min_kmer_mult=2, min_unit=2,
              min_inters=5, min_prop=3, prefix_threshold=2500,
              small_threshold=1000)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """test_read_placer.py's pipeline state, decomposed and given its
    unique k-mers by the JAX package; the decomposition goes to the port
    through the JAX package's decomposition.json."""
    assert jnative.load_native(build=True) is not None
    assert tnative.load_library() is not None
    rng = np.random.default_rng(7)
    unit = gen_random_seq(rng, UNIT)
    sim = simulate_tandem_repeat(rng, unit, mult=MULT, div_rate=0.02,
                                 flank_len=FLANK)
    g = sim.flanked_tr
    tr_start, tr_end = FLANK, FLANK + len(sim.tr)
    reads, true_offset = [], {}
    for pi, left in enumerate([3000, 2600, 2200]):
        reads.append((f"pre{pi}", g[tr_start - left:tr_start + 8 * UNIT]))
        true_offset[f"pre{pi}"] = 0
    i, start = 0, tr_start + 150
    while start + 3000 < tr_end - 200:
        reads.append((f"int{i:02d}", g[start:start + 3000]))
        lead_mod = (start - tr_start) % UNIT
        if lead_mod and (UNIT - lead_mod) > 0.2 * UNIT:
            true_offset[f"int{i:02d}"] = (start - tr_start) // UNIT
        else:
            true_offset[f"int{i:02d}"] = -((start - tr_start) // -UNIT)
        start += 700
        i += 1
    suf_start = tr_end - 8 * UNIT
    reads.append(("suf", g[suf_start:tr_end + 3000]))
    true_offset["suf"] = (suf_start - tr_start) // UNIT

    jdec = UnitDecomposer(unit, jconfig.UnitDecompositionConfig(
        min_record_len=1000)).decompose(reads)
    kcfg = jconfig.KmerRecruitmentConfig(k=K, min_distance=1, max_distance=5,
                                         min_coverage=2, bottom=0.0, top=1e9)
    records = {r: jdec.records[r] for r in sorted(jdec.records)}
    rare = get_rare_kmers([rec.seq for rec in records.values()], kcfg,
                          coverage=1, batch_rows=8)
    _, tensor, n_units, _ = jkc.pad_clouds(
        jkc.build_read_clouds(records, rare, K), sorted(records))
    uniq, _ = recruit_unique_kmers(tensor, n_units, rare, kcfg)
    assert len(uniq) > 50
    fn = str(tmp_path_factory.mktemp("dec") / "decomposition.json")
    jcenx.save_decomposition(jdec, fn)
    tdec = tcenx.load_decomposition(fn)
    jclouds = jkc.filter_read_clouds(
        jkc.build_read_clouds(records, uniq, K), min_mult=2)
    tclouds = tkc.filter_read_clouds(
        tkc.build_read_clouds({r: tdec.records[r] for r in sorted(records)},
                              uniq, K), min_mult=2)
    return dict(unit=unit, jdec=jdec, tdec=tdec, uniq=uniq, kcfg=kcfg,
                jclouds=jclouds, tclouds=tclouds, true_offset=true_offset)


def _clouds_equal(a, b):
    assert list(a) == list(b)
    for r in a:
        assert len(a[r].clouds) == len(b[r].clouds)
        for x, y in zip(a[r].clouds, b[r].clouds):
            np.testing.assert_array_equal(x, y)


def test_world_clouds_equal(world):
    _clouds_equal(world["tclouds"], world["jclouds"])


@pytest.mark.parametrize("use_fast", [True, False])
def test_placement_equal(world, use_fast, tmp_path):
    """Placements, scores and read_positions.csv equal the JAX
    package's, and every read sits at its true offset."""
    got = trp.ReadPlacer(tconfig.PlacerConfig(**PLACER), use_fast=use_fast,
                         device="cpu")
    want = jrp.ReadPlacer(jconfig.PlacerConfig(**PLACER), use_fast=use_fast)
    pg = got.run(world["tdec"], world["tclouds"])
    pw = want.run(world["jdec"], world["jclouds"])
    assert list(pg.items()) == list(pw.items())
    assert got.scores == want.scores
    assert pg == world["true_offset"]
    got.write_positions(str(tmp_path / "t.csv"))
    want.write_positions(str(tmp_path / "j.csv"))
    with open(tmp_path / "t.csv", "rb") as f, \
            open(tmp_path / "j.csv", "rb") as g:
        assert f.read() == g.read()
    assert trp.read_positions_file(str(tmp_path / "t.csv")) == \
        jrp.read_positions_file(str(tmp_path / "j.csv"))


def test_fast_placer_matches_dict_oracle(world):
    cfg = tconfig.PlacerConfig(**PLACER)
    fast = trp.ReadPlacer(cfg, use_fast=True, device="cpu")
    slow = trp.ReadPlacer(cfg, use_fast=False)
    assert fast.run(world["tdec"], world["tclouds"]) == \
        slow.run(world["tdec"], world["tclouds"])
    assert fast.scores == slow.scores


@pytest.mark.parametrize("max_vocab", [1 << 17, 0])
def test_host_init_matches_device_init(world, monkeypatch, max_vocab):
    """FastPlacer's bulk scoring on the device path (torch, here on the
    CPU), through the matmul scorer and, past the vocabulary switch,
    the popcount scorer, equals its numpy host mirror, score for
    score."""
    monkeypatch.setattr(tpf.FastPlacer, "_MATMUL_MAX_VOCAB", max_vocab)
    cfg = tconfig.PlacerConfig(**PLACER)
    prefix, internal, _ = world["tdec"].classify(
        cfg.prefix_threshold, cfg.small_threshold)
    placers = []
    for use_device in (True, False):
        contig = tpf.ArrayContig(cfg.min_cloud_kmer_freq)
        for r in prefix:
            contig.add_read(world["tclouds"][r], 0)
        placers.append(tpf.FastPlacer(contig, internal, world["tclouds"],
                                      cfg, use_device_init=use_device,
                                      device="cpu"))
    np.testing.assert_array_equal(placers[0].S0, placers[1].S0)
    np.testing.assert_array_equal(placers[0].S1, placers[1].S1)
    assert placers[0].S1.max() > 0


def test_pipeline_stage4_artifacts_equal(world, tmp_path):
    """run_placement and run_placement_validation write
    tr_resolution/read_positions.csv and placement_validation.csv byte
    for byte as the JAX pipeline does, return what it returns, and
    resume from them."""
    jcfg = jconfig.CentroFlyeConfig(
        coverage=1, kmer_recruitment=world["kcfg"],
        placer=jconfig.PlacerConfig(**PLACER))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    pipe = jcenx.CenXPipeline(world["unit"], jcfg, jdir, mesh=None)
    want_p, want_c = pipe.run_placement(world["jdec"], world["uniq"])
    want_a = pipe.run_placement_validation(want_p, want_c)
    pcfg = tconfig.PlacerConfig(**PLACER)
    kcfg = tconfig.KmerRecruitmentConfig(k=K)
    for resumed in (False, True):
        got_p, got_c = tcenx.run_placement(world["tdec"], world["uniq"],
                                           pcfg, K, tdir, device="cpu")
        got_a = tcenx.run_placement_validation(got_p, got_c, pcfg, kcfg,
                                               tdir)
        assert got_p == want_p and got_a == want_a
        _clouds_equal(got_c, want_c)
        for name in ("read_positions.csv", "placement_validation.csv"):
            with open(os.path.join(jdir, "tr_resolution", name), "rb") as f:
                jbytes = f.read()
            with open(os.path.join(tdir, "tr_resolution", name), "rb") as f:
                assert f.read() == jbytes, (name, resumed)
    assert len(got_a) >= 0.8 * len(got_p)


@pytest.mark.parametrize("seed", range(6))
def test_fast_placer_random_parity(seed):
    """Synthetic clouds with heavy score ties, every tie-break branch:
    the port's FastPlacer equals its dict oracle and the JAX package's
    FastPlacer."""
    rng = np.random.default_rng(seed)
    n_kmers, T_contig = 30, 12
    cfg = dict(min_cloud_kmer_freq=2, min_unit=1, min_inters=2, min_prop=1)

    def mk_read(r_id, n_units):
        return [np.sort(rng.choice(n_kmers, size=int(rng.integers(2, 5)),
                                   replace=False)).astype(np.int64)
                for _ in range(n_units)], r_id

    seeds = [mk_read(f"p{i}", T_contig) for i in range(3)]
    reads = [mk_read(f"r{i:02d}", int(rng.integers(3, 7))) for i in range(10)]
    reads.append(([c.copy() for c in reads[0][0]], "r99"))
    names = [r for _, r in reads]
    results = []
    for pkg_kc, pkg_cc, pkg_pf, pkg_rp, pkg_cfg, kw in (
            (tkc, tcc, tpf, trp, tconfig, dict(device="cpu")),
            (jkc, jcc, jpf, jrp, jconfig, {})):
        clouds = {r: pkg_kc.ReadClouds(r, c) for c, r in reads}
        pcfg = pkg_cfg.PlacerConfig(**cfg)

        def contig():
            c = pkg_cc.CloudContig(pcfg.min_cloud_kmer_freq)
            for cl, r in seeds:
                c.add_read(pkg_kc.ReadClouds(r, cl), position=0)
            return c

        results.append(pkg_pf.FastPlacer(contig(), names, clouds, pcfg,
                                         **kw).run())
        if pkg_pf is tpf:
            slow = pkg_rp.ReadPlacer(pcfg, use_fast=False)
            slow.contig = contig()
            slow._add_reads_oracle(names, clouds)
            assert results[0][0] == {r: slow.placements.get(r)
                                     for r in names}
            assert results[0][1] == slow.scores
    assert results[0] == results[1]


def _random_clouds(rng, R, T, K, V, fill=0.7):
    clouds = np.where(rng.random((R, T, K)) < fill,
                      rng.integers(0, V, size=(R, T, K)), -1).astype(np.int32)
    for r in range(R):                 # cloud k-mer sets are unique
        for t in range(T):
            _, first = np.unique(clouds[r, t], return_index=True)
            dup = np.ones(K, bool)
            dup[first] = False
            clouds[r, t, dup] = -1
    return clouds


def _scoring_case(seed, R, T, K, V, P, n_pairs, fill=0.7):
    rng = np.random.default_rng(seed)
    clouds = _random_clouds(rng, R, T, K, V, fill)
    ck = rng.integers(0, V, size=n_pairs)
    cp = rng.integers(0, P + 4, size=n_pairs)    # some beyond P: ignored
    uniq = sorted(set(zip(ck.tolist(), cp.tolist())))
    ck = np.array([u[0] for u in uniq], np.int32)
    cp = np.array([u[1] for u in uniq], np.int32)
    bm = np.zeros((P, max(1, -(-V // 32))), np.uint32)
    for v, p in uniq:
        if p < P:
            bm[p, v // 32] |= np.uint32(1) << np.uint32(v % 32)
    return clouds, ck, cp, bm


# (seed, R, T, K, V, P, pairs, fill): test_read_placer.py's case, one
# with a single unit, and dense ones whose counts pass 256, where a
# bfloat16 result would round
SCORING_CASES = [(5, 7, 6, 5, 97, 23, 60, 0.7), (6, 4, 1, 9, 40, 3, 30, 0.7),
                 (7, 3, 4, 420, 600, 5, 2800, 1.0),
                 (8, 2, 3, 700, 700, 2, 1400, 1.0)]


def _scores_all(clouds, ck, cp, bm, V, P, device):
    pc = tscoring.placement_scores(
        words_tensor(tscoring.clouds_to_bitmaps(clouds, V), device),
        words_tensor(bm, device))
    mm = tscoring.placement_scores_matmul(
        torch.from_numpy(clouds).to(device), torch.from_numpy(ck).to(device),
        torch.from_numpy(cp).to(device), n_kmers=V, n_pos=P)
    return [x.cpu().numpy() for x in (*pc, *mm)]


@pytest.mark.parametrize("case", SCORING_CASES)
def test_scorers_equal_jax(case):
    seed, R, T, K, V, P, n_pairs, fill = case
    clouds, ck, cp, bm = _scoring_case(seed, R, T, K, V, P, n_pairs, fill)
    np.testing.assert_array_equal(tscoring.clouds_to_bitmaps(clouds, V),
                                  jscoring.clouds_to_bitmaps(clouds, V))
    pc0, pc1, mm0, mm1 = _scores_all(clouds, ck, cp, bm, V, P, "cpu")
    j0, j1 = jscoring.placement_scores(jscoring.clouds_to_bitmaps(clouds, V),
                                       bm)
    for got in (pc0, pc1, mm0, mm1):
        assert got.dtype == np.int32 and got.shape == (R, P)
    np.testing.assert_array_equal(pc0, np.asarray(j0))
    np.testing.assert_array_equal(pc1, np.asarray(j1))
    np.testing.assert_array_equal(mm0, pc0)
    np.testing.assert_array_equal(mm1, pc1)
    jm0, jm1 = jscoring.placement_scores_matmul(clouds, ck, cp, n_kmers=V,
                                                n_pos=P)
    np.testing.assert_array_equal(mm1, np.asarray(jm1))
    if seed >= 7:
        assert pc1.max() > 256


def test_popcount32_exact():
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.integers(0, 1 << 32, 5000, dtype=np.uint64),
                        [0, 1, 0xFFFFFFFF, 0x80000000, 0x55555555]])
    got = tscoring.popcount32(torch.from_numpy(w.astype(np.int64)))
    want = [bin(int(x)).count("1") for x in w]
    assert got.tolist() == want


def test_device_map_reads_equal(world):
    """device_map_reads (no caller in either package) equals the JAX
    package's against the world's placed contig."""
    placer = trp.ReadPlacer(tconfig.PlacerConfig(**PLACER), device="cpu")
    placer.run(world["tdec"], world["tclouds"])
    ids, tensor, n_units, _ = tkc.pad_clouds(world["tclouds"])
    contig = placer.contig
    n_kmers = int(world["uniq"].size)
    for thr in ((5, 10), (2, 5)):
        got = tscoring.device_map_reads(
            tensor, n_units, contig.freq_clouds, contig.max_pos, n_kmers,
            threshold=thr, device="cpu")
        want = jscoring.device_map_reads(
            tensor, n_units, contig.freq_clouds, contig.max_pos, n_kmers,
            threshold=thr)
        assert got == want and len(got) > 0.8 * len(ids)
    np.testing.assert_array_equal(
        tscoring.contig_to_bitmap(contig.freq_clouds, contig.max_pos, n_kmers),
        jscoring.contig_to_bitmap(contig.freq_clouds, contig.max_pos,
                                  n_kmers))


def test_map_reads_fast_equal(world):
    """Validation's re-map against the dict contig, with the slow-oracle
    cross-check, equals the JAX package's."""
    cfg = tconfig.PlacerConfig(**PLACER)
    placer = trp.ReadPlacer(cfg, device="cpu")
    placements = placer.run(world["tdec"], world["tclouds"])
    got_c = tcc.CloudContig(cfg.min_cloud_kmer_freq)
    want_c = jcc.CloudContig(cfg.min_cloud_kmer_freq)
    for r_id, pos in placements.items():
        got_c.add_read(world["tclouds"][r_id], pos)
        want_c.add_read(world["jclouds"][r_id], pos)
    got = tcc.map_reads_fast(got_c, world["tclouds"], (2, 5), debug=True)
    want = jcc.map_reads_fast(want_c, world["jclouds"], (2, 5), debug=True)
    assert got[0] == want[0] and got[2] == want[2]
    assert {r: {p: dict(c) for p, c in s.items()}
            for r, s in got[1].items()} == \
        {r: {p: dict(c) for p, c in s.items()} for r, s in want[1].items()}


@pytest.mark.parametrize("seed", range(3))
def test_array_contig_matches_dict_contig_and_jax(seed):
    """ArrayContig agrees with the dict CloudContig on every observable,
    and with the JAX package's ArrayContig pair for pair."""
    rng = np.random.default_rng(100 + seed)
    ac, cc, jac = (tpf.ArrayContig(2), tcc.CloudContig(2),
                   jpf.ArrayContig(2))
    for ridx in range(12):
        clouds = [np.sort(rng.choice(25, size=int(rng.integers(0, 6)),
                                     replace=False)).astype(np.int64)
                  for _ in range(int(rng.integers(1, 8)))]
        pos = int(rng.integers(0, 10))
        got = ac.add_read(tkc.ReadClouds(f"r{ridx}", clouds), position=pos)
        assert sorted(got) == sorted(
            cc.add_read(tkc.ReadClouds(f"r{ridx}", clouds), position=pos))
        assert got == jac.add_read(jkc.ReadClouds(f"r{ridx}", clouds),
                                   position=pos)
        assert ac.max_pos == cc.max_pos == jac.max_pos
    assert ac.freq_kmers == cc.freq_kmers
    assert {k: v for k, v in cc.kmer_positions.items() if v} == \
        dict(ac.kmer_positions)
    assert {p: s for p, s in cc.freq_clouds.items() if s} == \
        dict(ac.freq_clouds)
    assert len(ac.clouds) == len(cc.clouds)
    assert ac.read_positions == cc.read_positions


def test_stages_2_and_4_run_with_jax_blocked(tmp_path):
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        from centroflye_tpu_torch.config import (KmerRecruitmentConfig,
            PlacerConfig, UnitDecompositionConfig)
        from centroflye_tpu_torch.io.fasta import write_seqs
        from centroflye_tpu_torch.pipeline.cenx import (run_decomposition,
            run_placement, run_placement_validation)
        from centroflye_tpu_torch.pipeline.simulate import (add_read_noise,
                                                            gen_random_seq)
        from centroflye_tpu_torch.ops import scoring
        rng = np.random.default_rng(0)
        unit = gen_random_seq(rng, 300)
        copies = []
        for c in range(16):
            u = list(unit)
            for j in range(3):
                p = (37 * c + 101 * j) % 300
                u[p] = "ACGT"[("ACGT".index(u[p]) + 1) % 4]
            copies.append("".join(u))
        arr = "".join(copies)
        flank = gen_random_seq(rng, 3000)
        reads = {f"pre{i}": flank[200 * i:] + arr[:1500] for i in range(3)}
        reads.update({f"int{i}": arr[300 * i + 120:300 * i + 2520]
                      for i in range(6)})
        reads = {r: add_read_noise(rng, s, 0.01) for r, s in reads.items()}
        fn = sys.argv[1] + "/reads.fasta"
        write_seqs(fn, reads)
        dec = run_decomposition(unit, fn, UnitDecompositionConfig(
            min_record_len=1000), sys.argv[1])
        assert len(dec.records) == 9, dec.records.keys()
        pcfg = PlacerConfig(prefix_threshold=2000, min_inters=3)
        kmers = set()
        for c in copies:
            for i in range(300 - 12):
                kmers.add(c[i:i + 13])
        from centroflye_tpu_torch.io.encoding import string_to_kmer_code
        uniq = np.sort(np.array([string_to_kmer_code(k) for k in kmers],
                                dtype=np.uint64))
        placements, clouds = run_placement(dec, uniq, pcfg, 13, sys.argv[1],
                                           device="cpu")
        agree = run_placement_validation(placements, clouds, pcfg,
                                         KmerRecruitmentConfig(),
                                         sys.argv[1])
        assert sum(p is not None for p in placements.values()) >= 6
        assert "jax" not in [m.split(".")[0] for m in sys.modules
                             if sys.modules[m] is not None]
        print("OK", len(agree))
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the scorers' CUDA path")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", SCORING_CASES)
def test_scorers_on_gpu_match_cpu(cuda, case):
    seed, R, T, K, V, P, n_pairs, fill = case
    clouds, ck, cp, bm = _scoring_case(seed, R, T, K, V, P, n_pairs, fill)
    want = _scores_all(clouds, ck, cp, bm, V, P, "cpu")
    for g, w in zip(_scores_all(clouds, ck, cp, bm, V, P, cuda), want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_placement_on_gpu_matches_cpu(cuda, world):
    cfg = tconfig.PlacerConfig(**PLACER)
    got = trp.ReadPlacer(cfg, device=cuda)
    want = trp.ReadPlacer(cfg, device="cpu")
    assert got.run(world["tdec"], world["tclouds"]) == \
        want.run(world["tdec"], world["tclouds"])
    assert got.scores == want.scores
