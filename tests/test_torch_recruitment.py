"""Stage 1 of cenX on the port: per-read recruitment results of the port
engine equal the JAX engine's on one stream, with the prefilter on and
off; the native fill and the numpy fill give the same results, from
strings and from code arrays, at seg_len 1024 and 1028, on a CPU mesh
and with the sequence-parallel tier; `recruit_file` (the native reader)
writes the same bytes; the JAX engine's tables carry across; and the
port runs with jax unimportable."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from centroflye_tpu.config import RecruitmentConfig as JConfig
from centroflye_tpu.io.encoding import revcomp_str
from centroflye_tpu.pipeline.simulate import add_read_noise, gen_random_seq
from centroflye_tpu.stages import recruitment as jrec

from centroflye_tpu_torch.config import RecruitmentConfig
from centroflye_tpu_torch.convert import (RECRUITMENT_STATE_KEYS,
                                          recruitment_state_from_numpy)
from centroflye_tpu_torch.ops.myers_cuda import myers_hw_2strand
from centroflye_tpu_torch.stages import recruitment as trec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THRESHOLD = 40
SEG_LEN = 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _stream(seed=23, n_short_tandem=20):
    """Tandem reads on both strands, background reads, reads with N
    bases, an empty read, duplicate ids, reads longer than the segment,
    a unit at a segment boundary, short unit fragments, and enough
    short tandem reads to overflow one candidate batch's budget."""
    rng = np.random.default_rng(seed)
    unit = gen_random_seq(rng, 150)
    rc = revcomp_str(unit)
    stride = SEG_LEN - (len(unit) + THRESHOLD - 1)
    reads = [
        ("tf0", add_read_noise(rng, unit * 6, 0.05)),
        ("tr0", add_read_noise(rng, rc * 6, 0.05)),
        ("bg0", gen_random_seq(rng, 1500)),
        ("n_tandem", unit[:70] + "NNNNN" + unit[70:] + unit),
        ("n_bg", gen_random_seq(rng, 300) + "N" * 30 + gen_random_seq(rng, 90)),
        ("empty", ""),
        ("dup", add_read_noise(rng, unit * 2, 0.05)),
        ("dup", gen_random_seq(rng, 400)),
        ("short", unit[:100]),
        ("boundary", gen_random_seq(rng, stride - 60) + unit
         + gen_random_seq(rng, 1200)),
        ("long_rc", gen_random_seq(rng, 2000) + add_read_noise(rng, rc, 0.05)
         + gen_random_seq(rng, 700)),
    ]
    for i in range(8):
        frag = 20 + 12 * i
        reads.append((f"frag{i}", gen_random_seq(rng, 100) + unit[:frag]
                      + gen_random_seq(rng, 200)))
    for i in range(n_short_tandem):
        src = unit if i % 2 else rc
        n = int(rng.integers(300, 450))
        reads.append((f"st{i}", add_read_noise(rng, src * 3, 0.05)[:n]))
        if i % 10 == 0:
            reads.append((f"sbg{i}", gen_random_seq(rng, n)))
    return unit, reads


def _tuples(results):
    return [(r.r_id, r.dist_fwd, r.dist_rc, r.recruited) for r in results]


def _jax_engine(unit, prefilter, batch_size):
    cfg = JConfig(threshold=THRESHOLD, batch_size=batch_size,
                  prefilter=prefilter)
    return jrec.RecruitmentEngine(unit, cfg, seg_len=SEG_LEN,
                                  use_pallas=False, mesh=None)


def _config(prefilter, batch_size):
    return RecruitmentConfig(threshold=THRESHOLD, batch_size=batch_size,
                             prefilter=prefilter)


@pytest.mark.parametrize("prefilter,batch_size,n_short_tandem", [
    (True, 16, 20),     # many small prescan and candidate batches
    (True, 512, 150),   # one 256-row candidate batch: survivor overflow
    (False, 16, 20),    # the exact tier alone
])
def test_engine_matches_jax(prefilter, batch_size, n_short_tandem):
    unit, reads = _stream(n_short_tandem=n_short_tandem)
    want = _tuples(_jax_engine(unit, prefilter, batch_size).run(reads))
    eng = trec.RecruitmentEngine(unit, _config(prefilter, batch_size),
                                 seg_len=SEG_LEN, device="cpu")
    n_pass = []
    if prefilter:                     # record each candidate batch's n_pass
        unbundle = eng._fused.unbundle

        def spy(out, B):
            res = unbundle(out, B)
            n_pass.append(res[3])
            return res
        eng._fused.unbundle = spy
    got = _tuples(eng.run(reads))
    assert got == want
    if prefilter:
        assert (max(n_pass) > eng.k_budget) == (batch_size > 256)
    by_id = {r[0]: r for r in got}
    for r_id in ("tf0", "tr0", "boundary", "long_rc", "n_tandem"):
        assert by_id[r_id][3], r_id
    assert by_id["boundary"][1] == 0
    for r_id in ("bg0", "n_bg", "empty", "short"):
        assert not by_id[r_id][3], r_id
    assert by_id["empty"][1:3] == (150, 150)
    assert [r[3] for r in got if r[0] == "dup"] == [True, False]


def test_recruit_file_bytes_match_jax(tmp_path):
    from centroflye_tpu.io import write_seqs
    unit, reads = _stream(seed=5, n_short_tandem=20)
    unit_fn = str(tmp_path / "unit.fasta")
    reads_fn = str(tmp_path / "reads.fasta")
    write_seqs(unit_fn, {"unit": unit})
    with open(reads_fn, "w") as f:          # duplicate ids kept
        for r_id, seq in reads:
            f.write(f">{r_id}\n{seq}\n")
    out_j = str(tmp_path / "jax.fasta")
    out_t = str(tmp_path / "port.fasta")
    n_j = jrec.recruit_file(unit_fn, reads_fn, out_j, THRESHOLD,
                            batch_size=16, seg_len=SEG_LEN, mesh=None)
    n_t = trec.recruit_file(unit_fn, reads_fn, out_t, THRESHOLD,
                            batch_size=16, seg_len=SEG_LEN, device="cpu")
    assert n_t == n_j > 10
    with open(out_j, "rb") as a, open(out_t, "rb") as b:
        assert a.read() == b.read()
    trec.main([unit_fn, reads_fn, out_t, str(THRESHOLD), "--batch-size",
               "16", "--device", "cpu"])
    with open(out_j, "rb") as a, open(out_t, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("fmt", ["fasta", "fastq.gz"])
def test_recruit_file_writes_the_jax_native_form(tmp_path, fmt):
    """With its native library built, the JAX package reads through its
    native reader and writes each recruited read as decoded codes: upper
    case, every other letter N. The port writes the same bytes, from
    FASTA and from gzipped FASTQ, on reads with soft-masked stretches
    and IUPAC letters."""
    import gzip
    from centroflye_tpu import native as jnative
    from centroflye_tpu.io import write_seqs
    assert jnative.load_native(build=True) is not None
    unit, reads = _stream(seed=11, n_short_tandem=10)
    rng = np.random.default_rng(4)
    iupac = "RYKMSWBDHVNrykmswbdhvn"
    odd = []
    for i, (r_id, seq) in enumerate(reads):
        if len(seq) > 40 and i % 2 == 0:
            a = int(rng.integers(0, len(seq) - 30))
            seq = seq[:a] + seq[a:a + 25].lower() + seq[a + 25:]
            b = int(rng.integers(0, len(seq) - 5))
            seq = seq[:b] + "".join(rng.choice(list(iupac), 4)) + seq[b + 4:]
            odd.append(r_id)
        reads[i] = (r_id, seq)
    unit_fn = str(tmp_path / "unit.fasta")
    write_seqs(unit_fn, {"unit": unit})
    reads_fn = str(tmp_path / f"reads.{fmt}")
    if fmt == "fasta":
        with open(reads_fn, "w") as f:
            for r_id, seq in reads:
                f.write(f">{r_id} some description\n{seq}\n")
    else:
        with gzip.open(reads_fn, "wt") as f:
            for r_id, seq in reads:
                f.write(f"@{r_id}\n{seq}\n+\n{'I' * len(seq)}\n")
    out_j = str(tmp_path / "jax.fasta")
    out_t = str(tmp_path / "port.fasta")
    n_j = jrec.recruit_file(unit_fn, reads_fn, out_j, THRESHOLD,
                            batch_size=16, seg_len=SEG_LEN, mesh=None)
    n_t = trec.recruit_file(unit_fn, reads_fn, out_t, THRESHOLD,
                            batch_size=16, seg_len=SEG_LEN, device="cpu")
    with open(out_j) as a, open(out_t) as b:
        jtext, ttext = a.read(), b.read()
    assert n_t == n_j > 10
    assert any(f">{r}\n" in jtext for r in odd)
    assert ttext == jtext


def _fill_routes(unit, reads, seg_len, prefilter, monkeypatch, mesh="auto",
                 **kw):
    """Per-read results of the port engine with the native fill and with
    the numpy fill, and each run's number of numpy pack_2bit calls."""
    from centroflye_tpu_torch.ops import fused_recruit as tfused
    calls = []
    pack = tfused.pack_2bit

    def spy(*a, **k):
        calls.append(1)
        return pack(*a, **k)
    monkeypatch.setattr(tfused, "pack_2bit", spy)
    out = {}
    for native_fill in (True, False):
        del calls[:]
        eng = trec.RecruitmentEngine(
            unit, RecruitmentConfig(threshold=THRESHOLD, batch_size=16,
                                    prefilter=prefilter, **kw),
            seg_len=seg_len, device="cpu", mesh=mesh,
            native_fill=native_fill)
        out[native_fill] = (_tuples(eng.run(reads)), len(calls))
    return out


@pytest.mark.parametrize("seg_len", [1024, 1028])
@pytest.mark.parametrize("prefilter", [True, False])
@pytest.mark.parametrize("as_codes", [False, True])
def test_native_and_numpy_fills_equal_jax(seg_len, prefilter, as_codes,
                                          monkeypatch):
    """The native fill (rows packed in place from the ASCII read or from
    int8 codes, N rows to the exact tier as they are filled) and the
    numpy fill give every read the JAX engine's (dist_fwd, dist_rc); the
    native fill runs only with the prefilter and seg_len % 8 == 0. With
    the prefilter and seg_len % 8 != 0 the JAX engine's numpy pack
    asserts at the first prescan, and so does the port's (a fault of the
    reference, kept)."""
    from centroflye_tpu.io.encoding import encode as jencode
    unit, reads = _stream(seed=31, n_short_tandem=40)
    if as_codes:
        reads = [(r, jencode(s)) for r, s in reads]
    jeng = jrec.RecruitmentEngine(
        unit, JConfig(threshold=THRESHOLD, batch_size=16,
                      prefilter=prefilter),
        seg_len=seg_len, use_pallas=False, mesh=None)
    if prefilter and seg_len % 8:
        with pytest.raises(AssertionError):
            list(jeng.run(reads))
        with pytest.raises(AssertionError):
            _fill_routes(unit, reads, seg_len, prefilter, monkeypatch)
        return
    want = _tuples(jeng.run(reads))
    out = _fill_routes(unit, reads, seg_len, prefilter, monkeypatch)
    assert out[True][0] == out[False][0] == want
    assert sum(r[3] for r in want) > 20
    assert out[True][1] == 0                    # no numpy pack
    assert (out[False][1] > 0) == prefilter


def _long_stream(seed=41):
    """Reads of 2,200-4,000 bases for the sequence-parallel tier (tandem
    on both strands, background, one with N) among short ones."""
    unit, reads = _stream(seed=seed, n_short_tandem=10)
    rng = np.random.default_rng(seed)
    rc = revcomp_str(unit)
    longs = [
        ("long_cen", gen_random_seq(rng, 1500) + add_read_noise(
            rng, unit * 3, 0.05) + gen_random_seq(rng, 1000)),
        ("long_rc", add_read_noise(rng, rc * 16, 0.05)),
        ("long_bg", gen_random_seq(rng, 3000)),
        ("long_n", gen_random_seq(rng, 2000) + "NNNN" + unit
         + gen_random_seq(rng, 300)),
    ]
    return unit, longs[:2] + reads[:12] + longs[2:] + reads[12:]


@pytest.mark.parametrize("n,min_len", [(2, 0), (4, 0), (2, 2000)])
def test_fills_equal_under_a_mesh_and_the_seqpar_tier(n, min_len,
                                                      monkeypatch):
    """On a CPU mesh, with the prefilter: the sharded fused tier
    (min_len 0: seq-par off), or with it the sequence-parallel tier
    (reads of at least 2,000 bases, encoded for the tier from the
    string): the native and numpy fills equal the JAX engine on its
    mesh."""
    from centroflye_tpu.parallel import mesh as jmesh
    from centroflye_tpu_torch.parallel import mesh as tmesh
    unit, reads = _long_stream()
    kw = dict(threshold=THRESHOLD, batch_size=16,
              seq_parallel_min_len=min_len)
    want = _tuples(jrec.RecruitmentEngine(
        unit, JConfig(**kw), seg_len=SEG_LEN, use_pallas=False,
        mesh=jmesh.make_mesh(n)).run(reads))
    out = _fill_routes(unit, reads, SEG_LEN, True, monkeypatch,
                       seq_parallel_min_len=min_len,
                       mesh=tmesh.make_mesh(n, devices=["cpu"] * n))
    assert out[True][0] == out[False][0] == want
    assert out[True][1] == 0 < out[False][1]
    by_id = {r[0]: r[3] for r in want}
    assert by_id["long_cen"] and by_id["long_rc"] and by_id["long_n"]
    assert not by_id["long_bg"]


def test_non_ascii_read_raises_as_in_jax():
    unit, reads = _stream(seed=2, n_short_tandem=0)
    reads = reads[:3] + [("bad", "ACGT\u00e9ACGT")]
    with pytest.raises(UnicodeEncodeError):
        list(_jax_engine(unit, True, 16).run(reads))
    with pytest.raises(UnicodeEncodeError):
        list(trec.RecruitmentEngine(unit, _config(True, 16),
                                    seg_len=SEG_LEN, device="cpu").run(reads))


@pytest.mark.parametrize("prefilter", [True, False])
def test_state_from_jax_engine(prefilter):
    unit, reads = _stream(seed=8, n_short_tandem=10)
    jeng = _jax_engine(unit, prefilter, 16)
    d = {k: getattr(jeng, k) for k in RECRUITMENT_STATE_KEYS
         if hasattr(jeng, k)}
    state = recruitment_state_from_numpy(d, "cpu")
    own = trec.RecruitmentEngine._build_state(unit, _config(prefilter, 16),
                                              "cpu")
    assert state.keys() == own.keys()
    for k in own:
        assert torch.equal(state[k], own[k]), k
    eng = trec.RecruitmentEngine.from_state(unit, _config(prefilter, 16),
                                            state, seg_len=SEG_LEN,
                                            device="cpu")
    assert _tuples(eng.run(reads)) == _tuples(jeng.run(reads))


@pytest.mark.parametrize("seed_k", [13, 11])
def test_seed_counts_match_jax(seed_k):
    """RecruitmentEngine.seed_counts (binary search in the seed table)
    equals the JAX engine's on one exact-tier batch of the stream."""
    from centroflye_tpu.io.encoding import encode_batch
    unit, reads = _stream(seed=3, n_short_tandem=10)
    codes, lens = encode_batch([s for _, s in reads], max_len=SEG_LEN)
    lens = np.minimum(lens, SEG_LEN).astype(np.int32)
    jeng = jrec.RecruitmentEngine(
        unit, JConfig(threshold=THRESHOLD, batch_size=16, seed_k=seed_k),
        seg_len=SEG_LEN, use_pallas=False, mesh=None)
    eng = trec.RecruitmentEngine(
        unit, RecruitmentConfig(threshold=THRESHOLD, batch_size=16,
                                seed_k=seed_k),
        seg_len=SEG_LEN, device="cpu")
    got = eng.seed_counts(codes, lens)
    want = jeng.seed_counts(codes, lens)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[0] > 100 and got[2] < 10        # tandem read, background


def test_segment_starts_match_jax():
    for rlen in (0, 1, 511, 512, 513, 1700, 5000):
        for seg, ov in ((512, 189), (1000, 300)):
            assert trec.segment_starts(rlen, seg, ov) == \
                jrec.segment_starts(rlen, seg, ov)


def test_port_runs_with_jax_blocked():
    code = """
import sys
sys.modules["jax"] = None
import numpy as np
from centroflye_tpu_torch.config import RecruitmentConfig
from centroflye_tpu_torch.pipeline.simulate import add_read_noise, gen_random_seq
import torch
from centroflye_tpu_torch.stages.recruitment import RecruitmentEngine
from centroflye_tpu_torch.ops import kmers, seed_filter, fused_recruit
from centroflye_tpu_torch.ops.myers import build_peq, myers_distance_batch
from centroflye_tpu_torch.ops.myers_cuda import (myers_hw_v3,
                                                 myers_hw_v3_banded)
rng = np.random.default_rng(0)
unit = gen_random_seq(rng, 120)
reads = [("t", add_read_noise(rng, unit * 4, 0.05)),
         ("b", gen_random_seq(rng, 600))]
for pf in (True, False):
    eng = RecruitmentEngine(unit, RecruitmentConfig(threshold=30,
        batch_size=8, prefilter=pf), seg_len=512, device="cpu")
    got = [r.recruited for r in eng.run(reads)]
    assert got == [True, False], got
    if pf:
        assert (eng.seed_counts(np.zeros((1, 512), np.int8),
                                np.array([512], np.int32)) == 0).all()
codes = torch.from_numpy(np.tile(np.arange(4, dtype=np.int8), 40)[None])
lens = torch.tensor([160], dtype=torch.int32)
peq = torch.from_numpy(build_peq(codes[0, :30].numpy()).astype(np.int64))
assert myers_hw_v3(peq, codes.t().contiguous(), lens, m=30)["dist"][0] == 0
assert myers_hw_v3_banded(peq, codes.t().contiguous(), lens, m=30,
                          k=3)["end"][0] == 29
assert myers_distance_batch(peq[None], codes, lens, m=30, collect="all",
                            ms=torch.tensor([30]))["scores"].shape == (1, 160)
assert kmers.pack_kmers(codes, lens, k=13)[2].all()
import tempfile
from centroflye_tpu_torch.config import KmerRecruitmentConfig
from centroflye_tpu_torch.pipeline.cenx import (load_decomposition,
                                                run_unique_kmers,
                                                save_decomposition)
from centroflye_tpu_torch.stages.unit_decomposition import (DecompRecord,
                                                            Decomposition)
from centroflye_tpu_torch.stages import distance_graph, kmer_cloud, rare_kmers
copies = []                   # ten unit copies, one substitution each
for c in range(10):
    u = list(unit)
    u[11 * c] = "ACGT"[("ACGT".index(u[11 * c]) + 1) % 4]
    copies.append("".join(u))
seq = "".join(copies)
bounds = np.arange(11, dtype=np.int32) * len(unit)
recs = {f"r{i}": DecompRecord(f"r{i}", len(seq), "+", 0, len(seq), seq,
                              bounds) for i in range(8)}
with tempfile.TemporaryDirectory() as tmp:
    save_decomposition(Decomposition(recs, {}, {}, []), tmp + "/d.json")
    uniq = run_unique_kmers(load_decomposition(tmp + "/d.json"),
                            KmerRecruitmentConfig(k=13, max_distance=3,
                                                  min_coverage=2, bottom=0.0),
                            8, tmp, device="cpu").codes
assert len(uniq) > 0, uniq
bad = sorted(m for m in sys.modules if m.split(".")[0] == "centroflye_tpu")
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


@pytest.mark.gpu
@pytest.mark.parametrize("prefilter,batch_size", [(True, 16), (True, 512),
                                                  (False, 16)])
def test_engine_on_gpu_matches_cpu(cuda, prefilter, batch_size):
    unit, reads = _stream(n_short_tandem=150)
    cfg = _config(prefilter, batch_size)
    want = _tuples(trec.RecruitmentEngine(unit, cfg, seg_len=SEG_LEN,
                                          device="cpu").run(reads))
    before = myers_hw_2strand.launches
    got = _tuples(trec.RecruitmentEngine(unit, cfg, seg_len=SEG_LEN,
                                         device=cuda).run(reads))
    assert myers_hw_2strand.launches > before
    assert got == want
