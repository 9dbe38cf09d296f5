"""Stage 5 of cenX and the consensus core of stage 6 on the port
(`utils/bio`, `io/encoding.compress_homopolymer`, `ops/align_path`,
`stages/consensus`, `stages/consensus_unit`) against the JAX package, on
numpy-seeded inputs: cigars, alignments, voting rounds, k-mer counts and
the rebuilt unit are strings and integers, so every comparison is exact.
Both native libraries are built first and asserted loaded: without its
library the JAX package takes other routes."""

import numpy as np
import pytest

from centroflye_tpu import native as jnative
from centroflye_tpu.config import ConsensusUnitConfig as JUnitConfig
from centroflye_tpu.io.encoding import \
    compress_homopolymer as j_compress_homopolymer
from centroflye_tpu.ops import align_path as jalign
from centroflye_tpu.pipeline.simulate import add_read_noise, gen_random_seq
from centroflye_tpu.stages import consensus as jcons
from centroflye_tpu.stages import consensus_unit as junit
from centroflye_tpu.utils import bio as jbio

from centroflye_tpu_torch import native as tnative
from centroflye_tpu_torch.config import ConsensusUnitConfig
from centroflye_tpu_torch.io.encoding import compress_homopolymer
from centroflye_tpu_torch.ops import align_path as talign
from centroflye_tpu_torch.stages import consensus as tcons
from centroflye_tpu_torch.stages import consensus_unit as tunit
from centroflye_tpu_torch.stages import rare_kmers as trare
from centroflye_tpu_torch.utils import bio as tbio


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert jnative.load_native(build=True) is not None, \
        "the JAX package's libcfnative.so did not build"
    assert tnative.load_library() is not None


def _fields(al):
    return (al.dist, al.cigar, al.a1, al.a2, al.t_start, al.t_end)


def test_bio_helpers_equal():
    rng = np.random.default_rng(1)
    for _ in range(20):
        a = gen_random_seq(rng, int(rng.integers(0, 60)))
        b = add_read_noise(rng, a, 0.1)
        assert tbio.hamming_distance(a, b, {"N"}) == \
            jbio.hamming_distance(a, b, {"N"})
        assert tbio.identity_shift(a, b, 5) == jbio.identity_shift(a, b, 5)
        if len(a) >= 20 and len(b) >= 20:    # an overlap exists
            assert tbio.overlap_alignment(a, b, 2, 3) == \
                jbio.overlap_alignment(a, b, 2, 3)
        s = "".join(rng.choice(list("AACGTT"), int(rng.integers(0, 40))))
        assert compress_homopolymer(s) == j_compress_homopolymer(s)


def test_parse_cigar_equal():
    rng = np.random.default_rng(2)
    for _ in range(30):
        q = gen_random_seq(rng, int(rng.integers(1, 200)))
        t = add_read_noise(rng, q, 0.15) or "A"
        al = jalign.align_path(q, t, mode="NW")
        assert tbio.parse_cigar(al.cigar) == jbio.parse_cigar(al.cigar)
        assert tbio.parse_cigar(al.cigar, q, t) == \
            jbio.parse_cigar(al.cigar, q, t)


@pytest.mark.parametrize("mode", ["NW", "HW"])
@pytest.mark.parametrize("prefer_native", [True, False])
def test_align_path_equal(mode, prefer_native):
    rng = np.random.default_rng(3)
    cases = [("", ""), ("", "ACGT"), ("ACGT", ""), ("A", "A"),
             ("ACGT", "TTTT"), ("ACNGT", "ACGGT")]
    for _ in range(25):
        q = gen_random_seq(rng, int(rng.integers(1, 300)))
        t = add_read_noise(rng, q, 0.1)
        if mode == "HW":
            t = gen_random_seq(rng, int(rng.integers(0, 80))) + t + \
                gen_random_seq(rng, int(rng.integers(0, 80)))
        cases.append((q, t))
    for q, t in cases:
        got = talign.align_path(q, t, mode=mode, prefer_native=prefer_native)
        want = jalign.align_path(q, t, mode=mode, prefer_native=prefer_native)
        assert _fields(got) == _fields(want), (q, t)


def test_align_path_takes_the_dp_where_native_fails(monkeypatch):
    """A native call that reports failure gives the numpy DP, in both
    packages."""
    monkeypatch.setattr(talign, "native_align_path", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "native_align_path", lambda *a, **k: None)
    rng = np.random.default_rng(4)
    q = gen_random_seq(rng, 90)
    t = gen_random_seq(rng, 30) + add_read_noise(rng, q, 0.1)
    for mode in ("NW", "HW"):
        got = talign.align_path(q, t, mode=mode)
        assert _fields(got) == _fields(jalign.align_path(q, t, mode=mode))
        assert _fields(got) == _fields(
            talign.align_path(q, t, mode=mode, prefer_native=False))


def test_hw_locate_equal():
    rng = np.random.default_rng(5)
    for _ in range(20):
        q = gen_random_seq(rng, int(rng.integers(1, 200)))
        t = gen_random_seq(rng, 50) + add_read_noise(rng, q, 0.1) + \
            gen_random_seq(rng, 50)
        assert talign.hw_locate(q, t) == jalign.hw_locate(q, t)
    for q, t in (("", "ACGT"), ("ACGT", ""), ("ACGT", "ACGT")):
        assert talign.hw_locate(q, t) == jalign.hw_locate(q, t)


def _round_inputs(rng, trial):
    truth = gen_random_seq(rng, 120 + 30 * trial)
    template = add_read_noise(rng, truth, 0.04)
    reads = [add_read_noise(rng, truth, 0.08)
             for _ in range(int(rng.integers(1, 12)))]
    if trial % 3 == 2:           # non-ACGT characters on both sides
        template = template[:40] + "N" + template[41:]
        reads[0] = reads[0][:25] + "NR" + reads[0][27:]
    return template, reads


def test_polish_round_equal():
    rng = np.random.default_rng(6)
    for trial in range(9):
        template, reads = _round_inputs(rng, trial)
        got = tcons.polish_round(template, reads)
        assert got == jcons.polish_round(template, reads)
        assert got == tcons._polish_round_aligned(template, reads)
    assert tcons.polish_round("ACGT", []) == "ACGT"
    assert tcons.polish_round("", ["ACGT"]) == ""


def test_vote_from_cigars_offsets_and_coverage_equal():
    rng = np.random.default_rng(7)
    for trial in range(8):
        truth = gen_random_seq(rng, 300)
        template = add_read_noise(rng, truth, 0.03)
        cigars, reads, offsets = [], [], []
        for _ in range(int(rng.integers(2, 10))):
            a = int(rng.integers(0, len(template) - 60))
            b = int(rng.integers(a + 40, len(template) + 1))
            seg = add_read_noise(rng, truth[a:b], 0.08)
            if trial % 2:
                seg = seg[:10] + "N" + seg[11:]
            al = jalign.align_path(template[a:b], seg, mode="NW")
            cig = al.cigar.translate(str.maketrans("ID", "DI"))
            cigars.append(cig)
            reads.append(seg)
            offsets.append(a)
        for min_cov in (1, 2, 3):
            got = tcons.vote_from_cigars(template, cigars, reads,
                                         offsets=offsets,
                                         min_coverage=min_cov)
            assert got == jcons.vote_from_cigars(
                template, cigars, reads, offsets=offsets,
                min_coverage=min_cov)


@pytest.mark.parametrize("n_iters", [1, 2, 4])
def test_polish_consensus_equal(n_iters):
    rng = np.random.default_rng(8)
    for trial in range(4):
        template, reads = _round_inputs(rng, trial)
        if trial == 3:
            reads = []
        assert tcons.polish_consensus(template, reads, n_iters) == \
            jcons.polish_consensus(template, reads, n_iters)


def test_fixed_point_stops_aligning(monkeypatch):
    """Once a round returns its template, later iterations are filled
    without another alignment, in both packages."""
    rng = np.random.default_rng(9)
    truth = gen_random_seq(rng, 150)
    reads = [truth] * 3
    calls = []
    real = tcons.polish_round
    monkeypatch.setattr(tcons, "polish_round",
                        lambda t, r: calls.append(1) or real(t, r))
    got = tcons.polish_consensus(truth, reads, n_iters=4)
    assert got == jcons.polish_consensus(truth, reads, n_iters=4)
    assert got == {i: truth for i in range(1, 5)} and len(calls) == 1


def test_negative_batch_distance_takes_the_char_walk(monkeypatch):
    """One negative distance in the native batch switches the whole round
    to the per-character walk (and its alignments to the per-pair path),
    in both packages, with the same template."""
    rng = np.random.default_rng(10)
    template, reads = _round_inputs(rng, 4)
    walks = []

    def stub(real):
        def batch(queries, target, mode="NW", threads=0):
            res = real(queries, target, mode=mode, threads=threads)
            return [(-1, "", 0, 0)] + res[1:]
        return batch

    monkeypatch.setattr(tcons, "native_align_path_batch",
                        stub(tnative.native_align_path_batch))
    monkeypatch.setattr(jnative, "native_align_path_batch",
                        stub(jnative.native_align_path_batch))
    real_walk = tcons._polish_round_aligned
    monkeypatch.setattr(tcons, "_polish_round_aligned",
                        lambda t, r: walks.append(1) or real_walk(t, r))
    assert tcons._batch_cigars(template, reads) is None
    assert jcons._batch_cigars(template, reads) is None
    got = tcons.polish_round(template, reads)
    assert walks == [1]
    assert got == jcons.polish_round(template, reads)
    monkeypatch.undo()
    assert got == tcons.polish_round(template, reads)


def _tandem_reads(rng, unit_len=120, n_reads=10, copies=6, noise=0.03):
    unit = gen_random_seq(rng, unit_len)
    reads = ["".join(add_read_noise(rng, unit, noise) for _ in range(copies))
             for _ in range(n_reads)]
    return unit, reads


def _numpy_counts(seqs, k):
    from collections import Counter
    c = Counter(s[i:i + k] for s in seqs for i in range(len(s) - k + 1)
                if set(s[i:i + k]) <= set("ACGT"))
    return c


@pytest.mark.parametrize("k", [21, 30])
@pytest.mark.parametrize("min_occ", [0, 8])
@pytest.mark.parametrize("capacity,batch_rows", [(None, 4), (256, 3)])
def test_count_kmers_total_equal(k, min_occ, capacity, batch_rows):
    """The port's device count against the JAX package's, and (without
    the occurrence mask) against a numpy count. capacity=256 is below
    every batch's distinct k-mers, so each batch's count and each merge
    of the forest double their capacity."""
    rng = np.random.default_rng(11)
    _, reads = _tandem_reads(rng)
    reads.insert(3, reads[3][:50] + "N" + reads[3][51:])
    reads.append("ACG")
    got = tunit.count_kmers_total(reads, k, batch_rows=batch_rows,
                                  capacity=capacity,
                                  min_occurrences=min_occ, device="cpu")
    want = junit.count_kmers_total(reads, k, batch_rows=batch_rows,
                                   capacity=capacity,
                                   min_occurrences=min_occ)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.uint64 and got[1].dtype == np.int64
    oracle = _numpy_counts(reads, k)
    if min_occ == 0:
        assert len(got[0]) == len(oracle) > 256
    from centroflye_tpu_torch.io.encoding import kmer_strings
    strs = kmer_strings(got[0], k)
    assert all(oracle[s] == c for s, c in zip(strs, got[1].tolist()))
    assert {s for s, c in oracle.items() if c >= min_occ} <= set(strs)


def test_count_kmers_total_capacity_doubles(monkeypatch):
    """capacity=256 makes both loops of the port's count run more than
    once: a batch's count_unique and a merge of two tables."""
    rng = np.random.default_rng(12)
    _, reads = _tandem_reads(rng)
    seen = {"count": [], "merge": []}
    real_count, real_merge = tunit.count_unique, trare.merge_count_tables

    def count(keys, *, capacity):
        seen["count"].append(capacity)
        return real_count(keys, capacity=capacity)

    def merge(*a, capacity):
        seen["merge"].append(capacity)
        return real_merge(*a, capacity=capacity)
    monkeypatch.setattr(tunit, "count_unique", count)
    monkeypatch.setattr(trare, "merge_count_tables", merge)
    got = tunit.count_kmers_total(reads, 21, batch_rows=3, capacity=256,
                                  device="cpu")
    want = junit.count_kmers_total(reads, 21, batch_rows=3, capacity=256)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert 512 in seen["count"] and max(seen["merge"]) > 512


def test_count_kmers_total_tables_track_distinct_count(monkeypatch):
    """The same reads counted 8 times over, in batches of 2: every table
    the forest merges is cut to a power of two of its distinct count, so
    no merge is wider than twice that of the whole count, although the
    windows add up to 8 times as many; the counts are the JAX
    package's."""
    rng = np.random.default_rng(14)
    _, reads = _tandem_reads(rng, n_reads=8, copies=12)
    reads = reads * 8
    seen = []
    real_merge = trare.merge_count_tables

    def merge(*a, capacity):
        seen.append(capacity)
        return real_merge(*a, capacity=capacity)
    monkeypatch.setattr(trare, "merge_count_tables", merge)
    got = tunit.count_kmers_total(reads, 21, batch_rows=2, device="cpu")
    want = junit.count_kmers_total(reads, 21, batch_rows=2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    windows = sum(len(r) - 20 for r in reads)
    assert windows > 8 * len(got[0])
    assert len(seen) >= 15
    assert max(seen) <= 2 * trare._pow2(len(got[0]))


def test_count_kmers_total_empty():
    for seqs in ([], ["ACG"]):
        got = tunit.count_kmers_total(seqs, 21, device="cpu")
        want = junit.count_kmers_total(seqs, 21)
        assert len(got[0]) == len(want[0]) == 0


@pytest.mark.parametrize("top_factor", [3, 1])
def test_reconstruct_unit_equal(top_factor):
    rng = np.random.default_rng(13)
    unit, reads = _tandem_reads(rng, n_reads=12, copies=8)
    got = tunit.reconstruct_unit(reads, unit,
                                 ConsensusUnitConfig(k=21,
                                                     top_factor=top_factor),
                                 batch_rows=4, device="cpu")
    want = junit.reconstruct_unit(reads, unit,
                                  JUnitConfig(k=21, top_factor=top_factor),
                                  batch_rows=4)
    assert got == want and len(got) > 0


def test_reconstruct_unit_threshold_tie():
    """Exact periodic reads give every unit k-mer 3 or 4 occurrences a
    read; decoy reads add k-mers with the lower count, so the top-n cut
    falls inside a tie, broken by k-mer string descending."""
    rng = np.random.default_rng(14)
    unit = gen_random_seq(rng, 60)
    reads = [unit * 4] * 8
    for _ in range(6):
        decoy = gen_random_seq(rng, 40)
        reads += [decoy] * 24
    cfg = dict(k=21, top_factor=1)
    codes, counts = tunit.count_kmers_total(reads, 21, device="cpu")
    n_top = len({(unit * 2)[i:i + 21] for i in range(60)})
    thr = int(np.partition(counts, -n_top)[-n_top])
    assert (counts > thr).sum() < n_top < (counts >= thr).sum()
    got = tunit.reconstruct_unit(reads, unit, ConsensusUnitConfig(**cfg),
                                 device="cpu")
    assert got == junit.reconstruct_unit(reads, unit, JUnitConfig(**cfg))


def test_reconstruct_unit_rotation_equal():
    """Reads of a rotated unit: unit* comes back in the input unit's
    phase, as in the JAX package."""
    rng = np.random.default_rng(15)
    unit = gen_random_seq(rng, 100)
    rot = unit[37:] + unit[:37]
    reads = [add_read_noise(rng, rot * 8, 0.01) for _ in range(8)]
    mutated = unit[:20] + ("A" if unit[20] != "A" else "C") + unit[21:]
    for given in (unit, mutated):
        got = tunit.reconstruct_unit(reads, given,
                                     ConsensusUnitConfig(k=21),
                                     device="cpu")
        assert got == junit.reconstruct_unit(reads, given,
                                             JUnitConfig(k=21))
    assert tunit.reconstruct_unit(reads, unit, ConsensusUnitConfig(k=21),
                                  device="cpu") == unit


@pytest.mark.gpu
@pytest.mark.parametrize("min_occ", [0, 8])
def test_count_kmers_total_on_gpu_matches_cpu(min_occ):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the count's CUDA path")
    rng = np.random.default_rng(16)
    _, reads = _tandem_reads(rng, n_reads=20)
    for k in (21, 30):
        got = tunit.count_kmers_total(reads, k, batch_rows=4, capacity=256,
                                      min_occurrences=min_occ,
                                      device="cuda")
        want = tunit.count_kmers_total(reads, k, batch_rows=4,
                                       capacity=256,
                                       min_occurrences=min_occ,
                                       device="cpu")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
