"""Stage 2 of cenX on the port (`stages/unit_decomposition.UnitDecomposer`,
`stages/ncrf_compat`, `pipeline/cenx.run_decomposition`) against the JAX
package on the same reads, exactly: every record (bounds, strand,
interval, sequence), every tandem interval, the read lengths, the
discarded reads and the classification. The cases mirror
tests/test_unit_decomposition.py. Both native libraries are built first
and must have loaded: without its library the JAX decomposer skips its
boundary probe and its bounds change."""

import dataclasses
import os

import numpy as np
import pytest

from centroflye_tpu import config as jconfig
from centroflye_tpu import native as jnative
from centroflye_tpu.io import read_seq, write_seqs
from centroflye_tpu.io.encoding import revcomp_str
from centroflye_tpu.pipeline import cenx as jcenx
from centroflye_tpu.pipeline.simulate import (add_read_noise, gen_random_seq,
                                              simulate_tandem_repeat)
from centroflye_tpu.stages import ncrf_compat as jncrf
from centroflye_tpu.stages import unit_decomposition as jud

from centroflye_tpu_torch import config as tconfig
from centroflye_tpu_torch import native as tnative
from centroflye_tpu_torch.pipeline import cenx as tcenx
from centroflye_tpu_torch.stages import ncrf_compat as tncrf
from centroflye_tpu_torch.stages import unit_decomposition as tud

UNIT_LEN = 400
DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "centroflye_tpu", "data")


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert jnative.load_native(build=True) is not None, \
        "the JAX package's libcfnative.so did not build"
    assert jnative.native_available()
    assert tnative.load_library() is not None


@pytest.fixture
def unit(rng):
    return gen_random_seq(rng, UNIT_LEN)


def assert_dec_equal(got, want):
    """A port Decomposition equals a JAX one, field by field."""
    assert list(got.records) == list(want.records)
    for r_id, w in want.records.items():
        g = got.records[r_id]
        assert type(g) is tud.DecompRecord
        for f in ("r_id", "r_len", "strand", "r_st", "r_en", "seq"):
            assert getattr(g, f) == getattr(w, f), (r_id, f)
        assert g.bounds.dtype == w.bounds.dtype == np.int32
        np.testing.assert_array_equal(g.bounds, w.bounds)
    assert got.positions_all == want.positions_all
    assert got.read_lens == want.read_lens
    assert got.discarded == want.discarded


def decompose_both(unit, reads, min_record_len=1000):
    got = tud.UnitDecomposer(unit, tconfig.UnitDecompositionConfig(
        min_record_len=min_record_len)).decompose(reads)
    want = jud.UnitDecomposer(unit, jconfig.UnitDecompositionConfig(
        min_record_len=min_record_len)).decompose(reads)
    assert_dec_equal(got, want)
    return got


def test_config_defaults_equal():
    for name in ("UnitDecompositionConfig", "PlacerConfig"):
        got = dataclasses.fields(getattr(tconfig, name))
        want = dataclasses.fields(getattr(jconfig, name))
        assert [(f.name, f.type, f.default) for f in got] == \
            [(f.name, f.type, f.default) for f in want]


def test_clean_tandem_boundaries(unit):
    read = unit * 6
    dec = decompose_both(unit, [("r0", read)])
    rec = dec.records["r0"]
    assert rec.bounds.tolist() == [i * UNIT_LEN for i in range(7)]
    assert rec.motif_alignments() == [unit] * 6


def test_noisy_tandem_instances(unit, rng):
    copies = [add_read_noise(rng, unit, 0.1) for _ in range(8)]
    dec = decompose_both(unit, [("r0", "".join(copies))])
    assert dec.records["r0"].n_units == 8


def test_reverse_strand_canonicalization(unit, rng):
    read_f = "".join(add_read_noise(rng, unit, 0.08) for _ in range(5))
    dec = decompose_both(unit, [("r0", revcomp_str(read_f))])
    assert dec.records["r0"].strand == "-"
    assert dec.records["r0"].n_units == 5


def test_flanked_read_interval(unit, rng):
    tr = "".join(add_read_noise(rng, unit, 0.1) for _ in range(6))
    read = gen_random_seq(rng, 3000) + tr + gen_random_seq(rng, 2000)
    rec = decompose_both(unit, [("r0", read)]).records["r0"]
    assert abs(rec.r_st - 3000) < 0.2 * UNIT_LEN


def test_min_record_len_filter_and_no_repeat(unit, rng):
    reads = [("short", unit * 2), ("none", gen_random_seq(rng, 5000)),
             ("ok", unit * 4)]
    dec = decompose_both(unit, reads, min_record_len=1000)
    assert "short" in dec.discarded and "short" not in dec.records
    assert "none" not in dec.records and "ok" in dec.records


@pytest.mark.parametrize("strand", ["+", "-"])
def test_classify_prefix_internal_suffix(unit, rng, strand):
    sim = simulate_tandem_repeat(rng, unit, mult=40, div_rate=0.02,
                                 flank_len=8000)
    g = sim.flanked_tr
    tr_start, tr_end = 8000, 8000 + len(sim.tr)
    reads = [("pre", g[tr_start - 6000:tr_start + 4000]),
             ("int", g[tr_start + 2000:tr_start + 9000]),
             ("suf", g[tr_end - 4000:tr_end + 6000])]
    flip = revcomp_str if strand == "-" else (lambda s: s)
    reads = [(r_id, flip(add_read_noise(rng, s, 0.05)))
             for r_id, s in reads]
    dec = decompose_both(unit, reads)
    jdec = jud.Decomposition(dec.records, dec.positions_all, dec.read_lens,
                             dec.discarded)
    for kw in (dict(large_threshold=5000, small_threshold=1000),
               dict(large_threshold=5000)):
        got = dec.classify(**kw)
        assert got == jdec.classify(**kw)
        assert got == (["pre"], ["int"], ["suf"])
    assert dec.get_efficiency() == jdec.get_efficiency()


def test_dxz1_at_ont_noise_probes_boundaries(monkeypatch):
    """The real DXZ1 unit at 12% error, both strands: the boundary probe
    (the native call) runs, and every record equals the JAX package's."""
    unit = read_seq(os.path.join(DATA, "DXZ1_rc.fasta"))
    U = len(unit)
    rng = np.random.default_rng(120)
    sim = simulate_tandem_repeat(rng, unit, mult=12, div_rate=0.002,
                                 flank_len=2000)
    g = sim.flanked_tr
    reads = []
    for j in range(4):
        seq = g[2000 + j * U:2000 + (j + 7) * U]
        if j % 2:
            seq = revcomp_str(seq)
        reads.append((f"r{j}", add_read_noise(rng, seq, 0.12)))
    calls = []
    probe = tud.native_edit_distance
    monkeypatch.setattr(tud, "native_edit_distance",
                        lambda *a, **kw: calls.append(1) or probe(*a, **kw))
    dec = decompose_both(unit, reads, min_record_len=5000)
    assert calls, "no boundary was probed"
    assert {r.strand for r in dec.records.values()} == {"+", "-"}


def test_split_motif_alignment_equal(rng):
    motif = "ACGTTGCA"
    for _ in range(30):
        m_al = "".join(c + "-" * int(rng.integers(0, 2) * rng.integers(0, 3))
                       for c in motif * int(rng.integers(1, 5)))
        m_al = m_al[int(rng.integers(0, 4)):]
        r_al = "".join("ACGT-"[int(i)] for i in rng.integers(0, 5, len(m_al)))
        assert tncrf.split_motif_alignment(motif, m_al, r_al) == \
            jncrf.split_motif_alignment(motif, m_al, r_al)


@pytest.fixture
def noisy_world(unit, rng):
    """Reads of a mutated tandem repeat on both strands, one with flanks,
    one too short, one without the repeat."""
    sim = simulate_tandem_repeat(rng, unit, mult=30, div_rate=0.01,
                                 flank_len=3000)
    g = sim.flanked_tr
    reads = []
    for i in range(6):
        st = 3000 + i * 900
        seq = g[st:st + 4000]
        reads.append((f"r{i}", revcomp_str(seq) if i % 2 else seq))
    reads.append(("flank", g[:3000 + 2500]))
    reads.append(("short", unit * 2))
    reads.append(("none", gen_random_seq(rng, 3000)))
    return [(r, add_read_noise(rng, s, 0.06)) for r, s in reads]


def test_parse_ncrf_report_equal(unit, noisy_world, tmp_path):
    """A report that the JAX package's write_ncrf_like_report writes
    parses to the same Decomposition in both packages."""
    dec = jud.UnitDecomposer(unit, jconfig.UnitDecompositionConfig(
        min_record_len=1000)).decompose(noisy_world)
    report = str(tmp_path / "report.ncrf")
    jncrf.write_ncrf_like_report(dec, unit, report)
    for min_len in (1000, 3000):
        got = tncrf.parse_ncrf_report(report, min_record_len=min_len)
        want = jncrf.parse_ncrf_report(report, min_record_len=min_len)
        assert_dec_equal(got, want)
        assert got.records
    assert set(tncrf.parse_ncrf_report(report, 1000).records) == \
        set(dec.records)


@pytest.mark.parametrize("pinned", [False, True])
def test_run_decomposition_artifact_equal(unit, noisy_world, tmp_path,
                                          pinned):
    """`run_decomposition` writes decomposition.json byte for byte as the
    JAX pipeline's stage 2 does, from the reads or a pinned report, and
    resumes from it."""
    reads_fn = str(tmp_path / "reads.fasta")
    write_seqs(reads_fn, dict(noisy_world))
    cfg = jconfig.CentroFlyeConfig(decomposition=jconfig.
                                   UnitDecompositionConfig(
                                       min_record_len=1000))
    report = None
    if pinned:
        report = str(tmp_path / "report.ncrf")
        jncrf.write_ncrf_like_report(
            jud.UnitDecomposer(unit, cfg.decomposition).decompose(
                noisy_world), unit, report)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    want = jcenx.CenXPipeline(unit, cfg, jdir, ncrf_report=report,
                              mesh=None).run_decomposition(reads_fn)
    got = tcenx.run_decomposition(
        unit, reads_fn, tconfig.UnitDecompositionConfig(min_record_len=1000),
        tdir, ncrf_report=report)
    assert_dec_equal(got, want)
    with open(os.path.join(jdir, "decomposition.json"), "rb") as f:
        jbytes = f.read()
    with open(os.path.join(tdir, "decomposition.json"), "rb") as f:
        assert f.read() == jbytes
    # resume: the artifact is read back, not recomputed
    again = tcenx.run_decomposition(unit, "no-such-file.fasta",
                                    tconfig.UnitDecompositionConfig(), tdir)
    assert_dec_equal(again, want)


def test_jax_decomposition_file_loads_equal(unit, noisy_world, tmp_path):
    """State carried across the packages: a decomposition.json that the
    JAX package saves loads into equal port records."""
    dec = jud.UnitDecomposer(unit, jconfig.UnitDecompositionConfig(
        min_record_len=1000)).decompose(noisy_world)
    fn = str(tmp_path / "decomposition.json")
    jcenx.save_decomposition(dec, fn)
    got = tcenx.load_decomposition(fn)
    assert_dec_equal(got, dec)
    assert got.classify(2000) == dec.classify(2000)
