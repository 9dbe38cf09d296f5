"""Stage 3 of cenX on the port as a whole: `pipeline/cenx.run_unique_kmers`
writes the same two artifact files, byte for byte, as the JAX package's
`CenXPipeline.run_unique_kmers` on the same decomposition (decomposed by
the JAX package, saved by it and loaded by the port), and resumes from
its own k-mer file. Also the stage's config defaults and host encoding
helpers against the JAX package's."""

import dataclasses
import os

import numpy as np
import pytest

from centroflye_tpu import config as jconfig
from centroflye_tpu.io import encoding as jenc
from centroflye_tpu.pipeline import cenx as jcenx
from centroflye_tpu.pipeline.simulate import (add_read_noise,
                                              simulate_tandem_repeat)
from centroflye_tpu.stages.unit_decomposition import UnitDecomposer

from centroflye_tpu_torch import config as tconfig
from centroflye_tpu_torch.io import encoding as tenc
from centroflye_tpu_torch.pipeline import cenx as tcenx

ARTIFACTS = ("unique_kmers_min_edge_cov_{c}.txt",
             "unique_edges_min_edge_cov_{c}.txt")


def test_config_defaults_equal():
    got = dataclasses.fields(tconfig.KmerRecruitmentConfig)
    want = dataclasses.fields(jconfig.KmerRecruitmentConfig)
    assert [(f.name, f.type, f.default) for f in got] == \
        [(f.name, f.type, f.default) for f in want]
    assert tconfig.COVERAGE == jconfig.CentroFlyeConfig().coverage


@pytest.mark.parametrize("k", [1, 13, 19, 31])
def test_kmer_string_helpers_equal(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << (2 * k), 50, dtype=np.uint64)
    strs = tenc.kmer_strings(codes, k)
    assert strs == jenc.kmer_strings(codes, k)
    assert [tenc.string_to_kmer_code(s) for s in strs] == codes.tolist()
    hi, lo = tenc.split_u64(codes)
    np.testing.assert_array_equal(tenc.join_u64(hi, lo),
                                  jenc.join_u64(hi, lo))
    with pytest.raises(ValueError):
        tenc.string_to_kmer_code("ACGN")


def _world(seed, noise, n_reads):
    """A mutated tandem repeat, reads tiling it, and their decomposition
    by the JAX package."""
    rng = np.random.default_rng(seed)
    unit = "".join("ACGT"[i] for i in rng.integers(0, 4, 250))
    sim = simulate_tandem_repeat(rng, unit, mult=30, div_rate=0.01,
                                 flank_len=0)
    reads = []
    for i in range(n_reads):
        st = (i * 547) % (len(sim.tr) - 3000)
        reads.append((f"t{i}", add_read_noise(rng, sim.tr[st:st + 3000],
                                              noise)))
    dec = UnitDecomposer(unit, jconfig.UnitDecompositionConfig(
        min_record_len=500)).decompose(reads)
    return unit, dec


@pytest.mark.parametrize("seed,noise,n_reads,cfg_kw", [
    (0, 0.0, 12, dict(max_distance=4, min_coverage=2)),
    (1, 0.01, 16, dict(max_distance=6, min_coverage=3)),
    (2, 0.0, 12, dict(max_distance=4, min_coverage=4,
                      auto_min_coverage=True)),
])
def test_run_unique_kmers_artifacts_equal_jax(tmp_path, seed, noise,
                                              n_reads, cfg_kw):
    unit, dec = _world(seed, noise, n_reads)
    kw = dict(k=13, bottom=0.0, top=1e9, **cfg_kw)
    jcfg = jconfig.CentroFlyeConfig(
        coverage=1, kmer_recruitment=jconfig.KmerRecruitmentConfig(**kw))
    jdir, tdir = os.path.join(tmp_path, "jax"), os.path.join(tmp_path, "t")
    want = jcenx.CenXPipeline(unit, jcfg, jdir,
                              mesh=None).run_unique_kmers(dec)
    dec_fn = os.path.join(tmp_path, "decomposition.json")
    jcenx.save_decomposition(dec, dec_fn)
    tcfg = tconfig.KmerRecruitmentConfig(**kw)
    res = tcenx.run_unique_kmers(tcenx.load_decomposition(dec_fn), tcfg,
                                 1, tdir, device="cpu")
    got = res.codes
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint64 and len(got) > 0
    assert np.isin(got, res.rare).all() and len(res.edges.i) > 0
    assert res.clouds.shape[0] == len(res.n_units) == len(dec.records)
    for name in ARTIFACTS:
        name = name.format(c=kw["min_coverage"])
        with open(os.path.join(jdir, "recruited_unique_kmers", name),
                  "rb") as f:
            want_bytes = f.read()
        with open(os.path.join(tdir, "recruited_unique_kmers", name),
                  "rb") as f:
            assert f.read() == want_bytes and want_bytes, name
    # resume: the k-mer artifact is read back, not recomputed
    again = tcenx.run_unique_kmers(dec, tcfg, 1, tdir, device="cpu")
    np.testing.assert_array_equal(again.codes, got)
    assert again.rare is None and again.edges is None
