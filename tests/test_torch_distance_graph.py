"""The port's k-mer clouds and distance graph (`stages/kmer_cloud.py`,
`stages/distance_graph.py`) against the JAX package on the same
numpy-seeded inputs, exactly: clouds, the materialized (i, j, d) table,
the host filter, and `recruit_unique_kmers` over every sweep path (one
and several strips, raw and table strips, the overflow split, adaptive
striping, the JAX package's compaction fallbacks against the port's one
compaction, host-planned strips, uncanonical
rows, the adaptive edge cutoff). The cloud worlds are those of
`tests/test_kmer_recruitment.py`."""

import os

import numpy as np
import pytest
import torch

from centroflye_tpu.config import KmerRecruitmentConfig as JCfg
from centroflye_tpu.config import UnitDecompositionConfig
from centroflye_tpu.pipeline import cenx as jcenx
from centroflye_tpu.pipeline.simulate import add_read_noise, gen_random_seq
from centroflye_tpu.stages import distance_graph as jdg
from centroflye_tpu.stages import kmer_cloud as jkc
from centroflye_tpu.stages.rare_kmers import get_rare_kmers
from centroflye_tpu.stages.unit_decomposition import UnitDecomposer

from centroflye_tpu_torch.config import KmerRecruitmentConfig as TCfg
from centroflye_tpu_torch.pipeline import cenx as tcenx
from centroflye_tpu_torch.stages import distance_graph as tdg
from centroflye_tpu_torch.stages import kmer_cloud as tkc

K = 13


def _cfgs(**kw):
    return JCfg(k=K, **kw), TCfg(k=K, **kw)


def _edges(e):
    return sorted(zip(e.i.tolist(), e.j.tolist(), e.dist.tolist(),
                      e.freq.tolist()))


def _same_recruit(tensor, n_units, rare, cfg_kw, jax_kw=(), **kw):
    """recruit_unique_kmers on both packages (`jax_kw` to the JAX one
    only): equal codes, edge lists (in the same order), unique indices
    and cutoff. Returns the port's."""
    jc, tc = _cfgs(**cfg_kw)
    ju, je = jdg.recruit_unique_kmers(tensor, n_units, rare, jc,
                                      **dict(jax_kw), **kw)
    tu, te = tdg.recruit_unique_kmers(tensor, n_units, rare, tc,
                                      device="cpu", **kw)
    np.testing.assert_array_equal(tu, ju)
    assert tu.dtype == ju.dtype
    for f in ("i", "j", "dist", "freq", "unique_kmer_indices"):
        np.testing.assert_array_equal(getattr(te, f), getattr(je, f),
                                      err_msg=f)
        assert getattr(te, f).dtype == getattr(je, f).dtype, f
    assert te.min_coverage_used == je.min_coverage_used
    return tu, te


def _random_clouds(rng, R, T, Kc, n_kmers, min_units, min_size=0,
                   sort=False):
    tensor = np.full((R, T, Kc), -1, np.int32)
    n_units = np.zeros(R, np.int32)
    for r in range(R):
        nu = int(rng.integers(min_units, T + 1))
        n_units[r] = nu
        for t in range(nu):
            sz = int(rng.integers(min_size, Kc + 1))
            ids = rng.choice(n_kmers, size=sz, replace=False)
            tensor[r, t, :sz] = np.sort(ids) if sort else ids
    return tensor, n_units


def _shared_clouds(rng, R, T, Kc, n_kmers, drop=0.0):
    per_pos = [np.sort(rng.choice(n_kmers, size=Kc, replace=False))
               for _ in range(T)]
    tensor = np.stack([np.stack(per_pos)] * R).astype(np.int32)
    if drop:
        tensor[rng.random(tensor.shape) < drop] = -1
        tensor = np.ascontiguousarray(np.sort(tensor, axis=2))
    return tensor, np.full(R, T, np.int32)


def _decomposition(tmp_path, seed):
    """A UnitDecomposer decomposition of noisy tandem reads, written by
    the JAX package and read back by the port (both ways the same)."""
    rng = np.random.default_rng(seed)
    unit = gen_random_seq(rng, 100)
    reads = [(f"r{i:03d}", "".join(add_read_noise(rng, unit, 0.05)
                                   for _ in range(6))) for i in range(5)]
    dec = UnitDecomposer(unit, UnitDecompositionConfig(
        min_record_len=300)).decompose(reads)
    fn = os.path.join(tmp_path, "dec.json")
    jcenx.save_decomposition(dec, fn)
    tdec = tcenx.load_decomposition(fn)
    fn2 = os.path.join(tmp_path, "dec2.json")
    tcenx.save_decomposition(tdec, fn2)
    assert open(fn, "rb").read() == open(fn2, "rb").read()
    assert len(tdec.records) == len(dec.records) >= 3
    return dec, tdec


def test_decomposition_records_match_jax(tmp_path):
    """The copied record methods: unit slices, efficiency and the
    prefix / internal / suffix split, on the loaded decomposition."""
    dec, tdec = _decomposition(tmp_path, 2)
    assert tdec.get_efficiency() == dec.get_efficiency()
    for large, small in ((0, 1000), (50, 10), (400, 100)):
        assert tdec.classify(large, small) == dec.classify(large, small)
    for r, rec in dec.records.items():
        assert tdec.records[r].motif_alignments() == rec.motif_alignments()
        assert tdec.records[r].n_units == rec.n_units > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_clouds_match_jax(tmp_path, seed):
    dec, tdec = _decomposition(tmp_path, seed)
    cfg, _ = _cfgs(bottom=0.0, top=100.0)
    seqs = [dec.records[r].seq for r in sorted(dec.records)]
    rare = get_rare_kmers(seqs, cfg, coverage=1, batch_rows=4)
    jrec = {r: dec.records[r] for r in sorted(dec.records)}
    trec = {r: tdec.records[r] for r in sorted(tdec.records)}
    jcl = jkc.build_read_clouds(jrec, rare, K)
    tcl = tkc.build_read_clouds(trec, rare, K)
    # a fault both packages share (ROADMAP Queue 3): with no genomic
    # codes every valid window is "found" at index 0
    jempty = jkc.build_read_clouds(jrec, rare[:0], K)
    tempty = tkc.build_read_clouds(trec, rare[:0], K)
    for r in jempty:
        for a, b in zip(tempty[r].clouds, jempty[r].clouds):
            np.testing.assert_array_equal(a, b)
    assert any(len(c) for rc in tempty.values() for c in rc.clouds)
    for min_mult in (1, 3):
        jf = jkc.filter_read_clouds(jcl, min_mult=min_mult)
        tf = tkc.filter_read_clouds(tcl, min_mult=min_mult)
        for got, want in ((tcl, jcl), (tf, jf)):
            assert list(got) == list(want)
            for r in want:
                assert got[r].n_units == want[r].n_units
                for a, b in zip(got[r].clouds, want[r].clouds):
                    np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(got[r].all_indices(),
                                              want[r].all_indices())
    for order in (None, sorted(trec)[::-1]):
        got, want = tkc.pad_clouds(tcl, order), jkc.pad_clouds(jcl, order)
        assert got[0] == want[0] and got[3] == want[3]
        for a, b in zip(got[1:3], want[1:3]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


def _same_table(tensor, n_units, cfg_kw, **kw):
    jc, tc = _cfgs(**cfg_kw)
    want = jdg.build_distance_table(tensor, n_units, jc, **kw)
    got = tdg.build_distance_table(tensor, n_units, tc, device="cpu", **kw)
    assert got[3] == want[3] > 0
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    return got


@pytest.mark.parametrize("cap,chunk", [(1 << 16, 4), (1 << 16, 1 << 12),
                                       (1 << 7, 32)])
def test_distance_table_matches_jax(cap, chunk):
    """Distances past 8, uncanonical rows (unsorted, holes), one strip
    and several; then the host filter on the table."""
    rng = np.random.default_rng(cap + chunk)
    tensor, n_units = _random_clouds(rng, 8, 24, 5, 60, 4)
    holes = np.full((8, 24, 7), -1, np.int32)
    holes[:, :, [0, 2, 3, 5, 6]] = tensor
    table = _same_table(holes, n_units, dict(min_distance=1,
                                             max_distance=12,
                                             min_coverage=1),
                        capacity=cap, entry_chunk=chunk)
    for min_cov, rel in ((1, 0.8), (2, 0.5), (3, 0.7)):
        jc, tc = _cfgs(min_coverage=min_cov, rel_threshold=rel)
        got = tdg.filter_dist_tuples(*table, tc)
        want = jdg.filter_dist_tuples(*table, jc)
        assert _edges(got) == _edges(want)
        np.testing.assert_array_equal(got.unique_kmer_indices,
                                      want.unique_kmer_indices)
    assert not len(tdg.filter_dist_tuples(*table[:3], 0, tc).i)


def test_multi_strip_sweep_matches_jax():
    """Several i-range strips (capacity far below the pair bound), the
    dedup hint, return_edges=False, and the overflow split (max_capacity
    at the strip capacity with an oversized hint)."""
    rng = np.random.default_rng(5)
    tensor, n_units = _random_clouds(rng, 6, 9, 23, 300, 7, min_size=1,
                                     sort=True)
    cfg_kw = dict(min_distance=1, max_distance=7, min_coverage=2)
    cap = 1 << 10
    assert tdg._pair_obs_bound(tensor, n_units, TCfg(**cfg_kw)) // cap >= 3
    _same_table(tensor, n_units, cfg_kw, capacity=cap, entry_chunk=64)
    rare = np.arange(300, dtype=np.uint64)
    uniq, edges = _same_recruit(tensor, n_units, rare, cfg_kw,
                                capacity=cap, entry_chunk=64)
    assert len(edges.i) > 0
    for kw in (dict(dedup_hint=8), dict(dedup_hint=1 << 12,
                                        max_capacity=cap)):
        u, e = _same_recruit(tensor, n_units, rare, cfg_kw, capacity=cap,
                             entry_chunk=64, **kw)
        np.testing.assert_array_equal(u, uniq)
        assert _edges(e) == _edges(edges)
    u, e = _same_recruit(tensor, n_units, rare, cfg_kw, capacity=cap,
                         entry_chunk=64, return_edges=False)
    np.testing.assert_array_equal(u, uniq)
    assert e.i.size == 0


def test_adaptive_striping_matches_jax():
    """Reads sharing their clouds (dedup ~R): the calibration coalesces
    strips, and the strip count and results equal the JAX sweep's."""
    rng = np.random.default_rng(6)
    tensor, n_units = _shared_clouds(rng, 12, 8, 16, 400)
    cfg_kw = dict(min_distance=1, max_distance=5, min_coverage=3)
    rare = np.arange(400, dtype=np.uint64)
    _same_recruit(tensor, n_units, rare, cfg_kw, capacity=1 << 9,
                  entry_chunk=128)
    counts = []
    for adaptive in (False, True):
        kw = dict(capacity=1 << 9, entry_chunk=128, adaptive=adaptive)
        jn = sum(1 for _ in jdg._strip_sweep(tensor, n_units,
                                             JCfg(k=K, **cfg_kw), **kw))
        tn = sum(1 for _ in tdg._strip_sweep(tensor, n_units,
                                             TCfg(k=K, **cfg_kw),
                                             device="cpu", **kw))
        assert tn == jn
        counts.append(tn)
    assert counts[1] < counts[0]


@pytest.mark.parametrize("chunk,jax_kw", [(1 << 16, {}), (64, {}),
                                         (1 << 16, {"out_small": 4}),
                                         (64, {"out_small": 4})])
def test_raw_and_table_strips_match_jax(chunk, jax_kw):
    """A big chunk sends every strip down the raw path, a tiny one down
    the table path; out_small=4 forces each of the JAX package's paths
    into its full-compaction fallback, and the port's one compaction (an
    index of the kept rows) must give the same edges."""
    rng = np.random.default_rng(7)
    tensor, n_units = _shared_clouds(rng, 14, 7, 10, 250, drop=0.25)
    _, e = _same_recruit(tensor, n_units, np.arange(250, dtype=np.uint64),
                         dict(min_distance=1, max_distance=5,
                              min_coverage=3), jax_kw=jax_kw,
                         capacity=1 << 11, entry_chunk=chunk)
    assert len(e.i) > 4


def test_host_planned_strips_match_jax():
    """Clouds of 2^16 slots or more take the host-planned segment path
    (the device plane's fields are 16 bits)."""
    rng = np.random.default_rng(8)
    small, n_units = _random_clouds(rng, 3, 5, 6, 40, 3, sort=True)
    tensor = np.full((3, 5, 1 << 16), -1, np.int32)
    tensor[:, :, :6] = small
    _same_table(tensor, n_units, dict(min_distance=1, max_distance=3,
                                      min_coverage=1),
                capacity=1 << 8, entry_chunk=16)
    _same_recruit(tensor, n_units, np.arange(40, dtype=np.uint64),
                  dict(min_distance=1, max_distance=3, min_coverage=1),
                  capacity=1 << 8, entry_chunk=16)


@pytest.mark.parametrize("rel", [0.8, 0.7071])
def test_uncanonical_rows_and_float_rule_match_jax(rel):
    """Unsorted rows with holes; rel 0.7071 is no fraction of denominator
    <= 64 that equals it in float, so the float32 rule decides."""
    rng = np.random.default_rng(9)
    tensor, n_units = _random_clouds(rng, 8, 14, 5, 60, 4)
    shuffled = tensor[:, :, ::-1].copy()
    assert not tdg._rel_fraction(0.7071)[2] and tdg._rel_fraction(0.8)[2]
    for cap in (1 << 16, 1 << 7):
        _same_recruit(shuffled, n_units, np.arange(60, dtype=np.uint64),
                      dict(min_distance=1, max_distance=9,
                           min_coverage=1, rel_threshold=rel),
                      capacity=cap, entry_chunk=32)


def _auto_world(step_down):
    R, T = (6, 8) if step_down else (10, 6)
    tensor = np.full((R, T, 3), -1, np.int32)
    for r in range(R):
        for t in range(T):
            base = (t + (r // 3) * T) % 32 if step_down else t
            tensor[r, t, :2] = (2 * base, 2 * base + 1)
    return tensor, np.full(R, T, np.int32)


@pytest.mark.parametrize("step_down", [True, False])
def test_auto_min_coverage_matches_jax(step_down):
    """Pair counts of 3 step the cutoff down below 4 (with the
    endpoint-degree cleanup); counts of 10 keep it at 4."""
    tensor, n_units = _auto_world(step_down)
    rare = np.arange(64, dtype=np.uint64)
    _, e = _same_recruit(tensor, n_units, rare,
                         dict(min_distance=1, max_distance=4,
                              min_coverage=4, auto_min_coverage=True),
                         capacity=1 << 14, entry_chunk=64)
    assert (e.min_coverage_used < 4) == step_down and len(e.i) > 0


def test_empty_clouds_match_jax():
    tensor = np.full((3, 4, 2), -1, np.int32)
    n_units = np.full(3, 4, np.int32)
    _, e = _same_recruit(tensor, n_units, np.arange(5, dtype=np.uint64),
                         dict(min_distance=1, max_distance=3),
                         capacity=1 << 8)
    assert e.i.size == 0


@pytest.mark.parametrize("density", [0.0, 0.01, 0.5, 1.0])
def test_nearest_marks_and_fill_equal_scans(density):
    """The sweep's nearest-boundary reads equal the JAX package's reverse
    cummin and forward cummax over non-decreasing values (no mark,
    sparse, dense, all marked); the boundary fill equals a repeat of each
    entry over its slots."""
    rng = np.random.default_rng(int(density * 100))
    n = 3000
    vals = np.cumsum(rng.integers(0, 3, n))
    mark = rng.random(n) < density
    right = np.minimum.accumulate(np.where(mark, vals, tdg._FAR)[::-1])[::-1]
    left = np.maximum.accumulate(np.where(mark, vals, 0))
    tm, tv = torch.from_numpy(mark), torch.from_numpy(vals)
    np.testing.assert_array_equal(
        tdg._nearest_right(tm, tv, tdg._FAR).numpy(), right)
    np.testing.assert_array_equal(tdg._nearest_left(tm, tv, 0).numpy(), left)
    # entries of 0-9 slots (empty ones collapse), the tail past `size`
    reps = rng.integers(0, 10, 400)
    cols = [rng.integers(-50, 50, 400) for _ in range(2)]
    size = int(reps.sum()) - 7
    bpos = torch.from_numpy(np.cumsum(reps)[:-1])
    got = tdg._fill_by_boundaries([torch.from_numpy(c) for c in cols],
                                  bpos, size)
    for g, c in zip(got, cols):
        np.testing.assert_array_equal(g.numpy(), np.repeat(c, reps)[:size])


def test_rejects_unpackable_keys():
    tensor, n_units = _random_clouds(np.random.default_rng(0), 2, 3, 2,
                                     5, 3)
    with pytest.raises(ValueError):
        tdg.recruit_unique_kmers(tensor, n_units, np.arange(5), TCfg(
            max_distance=256), device="cpu")
    too_many = np.broadcast_to(np.uint64(0), (1 << 24,))
    with pytest.raises(ValueError):
        tdg.recruit_unique_kmers(tensor, n_units, too_many, TCfg(),
                                 device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sweep's CUDA path")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [dict(entry_chunk=1 << 16),
                                dict(entry_chunk=64)])
def test_sweep_on_gpu_matches_cpu(cuda, kw):
    rng = np.random.default_rng(10)
    tensor, n_units = _shared_clouds(rng, 14, 7, 10, 250, drop=0.25)
    cfg = TCfg(k=K, min_distance=1, max_distance=5, min_coverage=3)
    rare = np.arange(250, dtype=np.uint64)
    want = tdg.recruit_unique_kmers(tensor, n_units, rare, cfg,
                                    capacity=1 << 11, device="cpu", **kw)
    got = tdg.recruit_unique_kmers(tensor, n_units, rare, cfg,
                                   capacity=1 << 11, device=cuda, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert _edges(got[1]) == _edges(want[1])
