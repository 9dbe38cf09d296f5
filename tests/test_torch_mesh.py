"""The port's device mesh (`parallel/mesh.py`) and the layers it shards,
on the CPU: a `Mesh` of n `cpu` devices (n in {2, 4, 8}) against the JAX
package's mesh of n of its 8 virtual CPU devices and against the port's
single-device path, on the same numpy-seeded inputs, exactly. The six
step functions; the fused step's shard-blocked bundle; the recruitment
engine's fused tier under a mesh; the monomer decomposer with a mesh;
stage 3 (rare k-mer table, distance table, `run_unique_kmers`' artifact
files byte for byte); the dry run.
Also the mesh's own rules (repeats, one device type, CUDA never quietly
the CPU), and the modules with jax unimportable. The `gpu` test holds K5
against its plain version on the card."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from centroflye_tpu import config as jconfig
from centroflye_tpu.io.encoding import encode_batch as jencode_batch
from centroflye_tpu.ops.myers import build_peq as jbuild_peq
from centroflye_tpu.parallel import mesh as jmesh_mod
from centroflye_tpu.pipeline import cenx as jcenx
from centroflye_tpu.pipeline.simulate import add_read_noise, gen_random_seq
from centroflye_tpu.stages import distance_graph as jdg
from centroflye_tpu.stages import rare_kmers as jrare
from centroflye_tpu.stages import recruitment as jrec
from jax.sharding import NamedSharding, PartitionSpec as P

from centroflye_tpu_torch import config as tconfig
from centroflye_tpu_torch.ops import fused_recruit as tfused
from centroflye_tpu_torch.ops.kmers import split_keys
from centroflye_tpu_torch.ops.myers import words_tensor
from centroflye_tpu_torch.parallel import mesh as tmesh
from centroflye_tpu_torch.stages import distance_graph as tdg
from centroflye_tpu_torch.stages import rare_kmers as trare
from centroflye_tpu_torch.stages import recruitment as trec

from test_torch_seq_parallel import k5_against_plain_on_gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARDS = [2, 4, 8]


def cpu_mesh(n):
    return tmesh.make_mesh(n, devices=["cpu"] * n)


def jmesh(n):
    assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"
    return jmesh_mod.make_mesh(n)


def _batch(seed, B=16, lo=100, hi=800, L=1024):
    rng = np.random.default_rng(seed)
    texts = ["".join("ACGT"[i] for i in rng.integers(0, 4, int(n)))
             for n in rng.integers(lo, hi, B)]
    return jencode_batch(texts, max_len=L)


# ---------------------------------------------------------------- the mesh


def test_mesh_devices_repeat_and_truncate():
    m = tmesh.make_mesh(3, devices=["cpu"] * 5, axis="seq")
    assert m.size == 3 and m.axis == "seq" and cpu_mesh(3).axis == "reads"
    assert m.first == torch.device("cpu") and m.devices == cpu_mesh(3).devices
    assert tmesh.make_mesh(0, devices=["cpu"] * 2).size == 2
    with pytest.raises(ValueError):
        tmesh.make_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        tmesh.Mesh([])


def test_mesh_holds_one_device_type_and_cuda_never_the_cpu():
    with pytest.raises(ValueError, match="one device type"):
        tmesh.Mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="cpu devices for a cuda run"):
        tmesh.resolve_mesh(cpu_mesh(2), "cuda")
    assert tmesh.resolve_mesh(cpu_mesh(1), "cpu") is None
    assert tmesh.resolve_mesh("auto", "cpu") is None
    with pytest.raises(ValueError):
        tmesh.resolve_mesh("all", "cpu")
    if not torch.cuda.is_available():
        assert tmesh.auto_mesh() is None
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(2)


def test_pad_rows_equals_jax():
    for rows in (0, 1, 5, 8):
        a = np.arange(rows * 3, dtype=np.int32).reshape(rows, 3)
        for mult in (1, 3, 8):
            np.testing.assert_array_equal(tmesh.pad_rows(a, mult, -1),
                                          jmesh_mod.pad_rows(a, mult, -1))


# --------------------------------------------------------- the step functions


@pytest.mark.parametrize("n", SHARDS)
def test_recruitment_step(n):
    rng = np.random.default_rng(n)
    unit = rng.integers(0, 4, 120).astype(np.int8)
    peq_f, peq_r = jbuild_peq(unit), jbuild_peq((3 - unit)[::-1].copy())
    codes, lens = _batch(n)
    jm = jmesh(n)
    jcodes, jlens = jmesh_mod.shard_batch(jm, codes, lens)
    want = jmesh_mod.make_recruitment_step(jm, 120)(peq_f, peq_r, jcodes,
                                                    jlens)
    got = tmesh.make_recruitment_step(cpu_mesh(n), 120)(
        words_tensor(peq_f, "cpu"), words_tensor(peq_r, "cpu"), codes, lens)
    single = tmesh.make_recruitment_step(cpu_mesh(1), 120)(
        words_tensor(peq_f, "cpu"), words_tensor(peq_r, "cpu"), codes, lens)
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), s.numpy())


@pytest.mark.parametrize("n", SHARDS)
def test_perrow_myers_step(n):
    """SHW/call against the JAX step's SHW rows and numpy's argmin of
    dist / m (the JAX decomposer's choice); HW/all against its rows."""
    rng = np.random.default_rng(10 + n)
    Q, R, L, m = 6, 16, 70, 40
    qs = [rng.integers(0, 4, int(k)).astype(np.int8)
          for k in rng.integers(20, m + 1, Q)]
    peqs = np.stack([jbuild_peq(q, m=m) for q in qs])
    ms = np.array([len(q) for q in qs], np.int32)
    windows = rng.integers(0, 5, (R, L)).astype(np.int8)
    wlens = rng.integers(0, L + 1, R).astype(np.int32)
    jm = jmesh(n)
    args = (np.tile(peqs, (R, 1, 1)), np.repeat(windows, Q, 0),
            np.repeat(wlens, Q), np.tile(ms, R))
    tpeqs, tms = torch.from_numpy(peqs.astype(np.int64)), torch.from_numpy(ms)
    for mode, collect in (("SHW", "call"), ("HW", "all")):
        jcollect = "best" if collect == "call" else collect
        want = jmesh_mod.make_perrow_myers_step(jm, m, mode, jcollect)(*args)
        got = tmesh.make_perrow_myers_step(cpu_mesh(n), tpeqs, tms, m=m,
                                           mode=mode, collect=collect)(
            windows, wlens)
        single = tmesh.make_perrow_myers_step(cpu_mesh(1), tpeqs, tms, m=m,
                                              mode=mode, collect=collect)(
            windows, wlens)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), single[k].numpy())
        if collect == "all":
            np.testing.assert_array_equal(got["scores"].numpy(),
                                          np.asarray(want["scores"]))
            continue
        dist = np.asarray(want["dist"]).reshape(R, Q)
        end = np.asarray(want["end"]).reshape(R, Q)
        q = np.argmin(dist / ms[None, :], axis=1)
        np.testing.assert_array_equal(got["q"].numpy(), q)
        np.testing.assert_array_equal(got["dist"].numpy(),
                                      dist[np.arange(R), q])
        np.testing.assert_array_equal(got["end"].numpy(),
                                      end[np.arange(R), q])


def _jax_table(uhi, ulo, cnt, n):
    n = int(n)
    return (np.asarray(uhi)[:n].astype(np.uint64) << np.uint64(32)
            | np.asarray(ulo)[:n].astype(np.uint64)), np.asarray(cnt)[:n]


def _port_table(keys, cnt, n):
    n = int(n)
    hi, lo = split_keys(keys[:n])
    return (hi.numpy().astype(np.uint64) << np.uint64(32)
            | lo.numpy().astype(np.uint64)), cnt[:n].numpy()


@pytest.mark.parametrize("n", SHARDS)
def test_kmer_count_step(n):
    codes, lens = _batch(20 + n, lo=50, hi=300, L=512)
    jm = jmesh(n)
    want = _jax_table(*jmesh_mod.make_kmer_count_step(jm, k=9, capacity=8192)(
        *jmesh_mod.shard_batch(jm, codes, lens)))
    got = _port_table(*tmesh.make_kmer_count_step(cpu_mesh(n), 9, 8192)(
        codes, lens))
    single = _port_table(*tmesh.make_kmer_count_step(cpu_mesh(1), 9, 8192)(
        codes, lens))
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("n", SHARDS)
def test_stats_count_step(n):
    rng = np.random.default_rng(30 + n)
    unit = "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
    seqs = [add_read_noise(rng, unit * 4, 0.05) for _ in range(16)]
    codes, lens = jencode_batch(seqs, max_len=256)
    rid = np.arange(16, dtype=np.int32)[:, None]
    jm = jmesh(n)
    jstep = jmesh_mod.make_stats_count_step(jm, 11, 4096)
    sh = NamedSharding(jm, P("reads", None))
    want = _jax_table(*jstep(jax.device_put(codes, sh),
                             jax.device_put(lens, NamedSharding(jm, P("reads"))),
                             jax.device_put(rid, sh)))
    got = _port_table(*tmesh.make_stats_count_step(cpu_mesh(n), 11, 4096)(
        codes, lens, rid))
    single = _port_table(*tmesh.make_stats_count_step(cpu_mesh(1), 11, 4096)(
        codes, lens, rid))
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


def _sub_buckets(seed):
    """A whole-range strip's sub-bucket list from random clouds (the
    host planning path of both packages)."""
    rng = np.random.default_rng(seed)
    R, T, K = 8, 9, 4
    clouds = np.sort(np.where(rng.random((R, T, K)) < 0.8,
                              rng.integers(0, 60, (R, T, K)), -1), axis=2)
    n_inv = (clouds < 0).sum(axis=2, keepdims=True)
    clouds = np.take_along_axis(
        clouds, (np.arange(K)[None, None, :] + n_inv) % K, axis=2
    ).astype(np.int32)
    sizes = (clouds >= 0).sum(axis=2).astype(np.int64)
    n_units = np.full(R, T, np.int32)
    b = jdg._strip_buckets(np.zeros_like(sizes), sizes, sizes, n_units, 1,
                           4, T, K)
    flat = clouds.reshape(-1).astype(np.int32)
    counts, *cols = jdg._expand_subbuckets(flat, *b)
    total = int(np.sum(counts))
    E = len(counts)                   # padded as the host path pads them
    Epad = 1 << int(np.ceil(np.log2(E)))
    starts = np.full(Epad + 1, total, np.int32)
    starts[:E + 1] = np.concatenate([[0], np.cumsum(counts)])
    padded = [np.zeros(Epad, np.int32) for _ in cols]
    for p, c in zip(padded, cols):
        p[:E] = c
    return flat, (starts, *padded), total


@pytest.mark.parametrize("n", SHARDS)
def test_pair_bucket_step(n):
    flat, bufs, total = _sub_buckets(40 + n)
    chunk, cap = 64 * 8, 1024
    jm = jmesh(n)
    jstep = jmesh_mod.make_pair_bucket_step(jm, chunk=chunk, capacity=cap)
    step = tmesh.make_pair_bucket_step(cpu_mesh(n), chunk=chunk, capacity=cap)
    single = tmesh.make_pair_bucket_step(cpu_mesh(1), chunk=chunk,
                                         capacity=cap)
    tbufs = [torch.from_numpy(flat)] + [torch.from_numpy(a.astype(np.int64))
                                        for a in bufs]
    rep = tuple(tmesh.replicate(cpu_mesh(n), b) for b in tbufs)
    for c0 in range(0, total, chunk):
        want = _jax_table(*jstep(flat, *bufs, np.int32(c0), np.int32(total)))
        got = _port_table(*step(*rep, c0, total))
        for g, w, s in zip(got, want,
                           _port_table(*single(*tbufs, c0, total))):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, s)
        assert len(got[0])


@pytest.mark.parametrize("n", SHARDS)
def test_placement_score_step(n):
    from centroflye_tpu.ops.scoring import clouds_to_bitmaps
    rng = np.random.default_rng(50 + n)
    clouds = rng.integers(-1, 64, size=(16, 6, 5)).astype(np.int32)
    read_bm = clouds_to_bitmaps(clouds, 64)
    contig_bm = rng.integers(0, 2**31, size=(12, 2)).astype(np.uint32)
    jm = jmesh(n)
    want = jmesh_mod.make_placement_score_step(jm)(
        jax.device_put(read_bm, NamedSharding(jm, P("reads", None, None))),
        jax.device_put(contig_bm, NamedSharding(jm, P(None, None))))
    args = (words_tensor(read_bm, "cpu"), words_tensor(contig_bm, "cpu"))
    got = tmesh.make_placement_score_step(cpu_mesh(n))(*args)
    single = tmesh.make_placement_score_step(cpu_mesh(1))(*args)
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), s.numpy())


# ------------------------------------------------ the layers under a mesh


def _stream(seed=3):
    rng = np.random.default_rng(seed)
    unit = gen_random_seq(rng, 150)
    reads = [(f"t{i}", add_read_noise(rng, unit * 4, 0.05)[:int(n)])
             for i, n in enumerate(rng.integers(300, 600, 40))]
    reads += [(f"b{i}", gen_random_seq(rng, 500)) for i in range(12)]
    reads += [("n", unit[:60] + "N" * 8 + unit * 2), ("empty", "")]
    return unit, reads


def _tuples(results):
    return [(r.r_id, r.dist_fwd, r.dist_rc, r.recruited) for r in results]


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("with_n,k_budget", [(False, 128), (True, 128),
                                             (False, 4)])
def test_fused_step_bundle_equals_jax(n, with_n, k_budget):
    """One fused step's shard-blocked bundle against the JAX package's
    sharded step (packed and N-masked paths; k_budget 4 overflows each
    shard); without overflow, unbundled, the single-device step's."""
    from centroflye_tpu.io import encoding as jenc
    from centroflye_tpu.ops import fused_recruit as jfused
    from centroflye_tpu.ops.seed_filter import build_seed_bitmap
    from test_torch_fused_recruit import _batch
    out = _batch(90 + n, 32, 320, 12, with_n=with_n)
    unit, packed, lens = out[0], out[1], out[-1]
    mask = out[2] if with_n else None
    uc = jenc.encode(unit)
    tables = (build_seed_bitmap(unit, 13), jbuild_peq(uc),
              jbuild_peq(jenc.revcomp(uc)))
    le = build_seed_bitmap(unit, 13, le=True)
    kw = dict(m=len(unit), seed_k=13, min_hits=8, k_budget=k_budget)
    jf = jfused.make_fused_recruit(*tables, use_pallas=False, mesh=jmesh(n),
                                   seed_bitmap_le=le, **kw)
    tt = [words_tensor(a, "cpu") for a in tables]
    tf = tfused.make_fused_recruit(*tt, seed_bitmap_le=words_tensor(le, "cpu"),
                                   mesh=cpu_mesh(n), **kw)
    want = np.asarray(jf.raw(packed, mask, lens))
    got = tf.raw(packed, mask, lens).numpy()
    np.testing.assert_array_equal(got, want)
    assert tf.n_dev == n and tf.unbundle(got, 32)[3] == \
        jf.unbundle(want, 32)[3]
    if k_budget == 128:
        single = tfused.make_fused_recruit(
            *tt, seed_bitmap_le=words_tensor(le, "cpu"), **kw)(
            packed, mask, lens)
        for a, b in zip(tf.unbundle(got, 32)[:3], single[:3]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", SHARDS)
def test_engine_fused_tier_under_a_mesh(n):
    unit, reads = _stream(60 + n)
    cfg = dict(threshold=40, batch_size=16, seq_parallel_min_len=0)
    want = _tuples(jrec.RecruitmentEngine(
        unit, jconfig.RecruitmentConfig(**cfg), seg_len=512,
        use_pallas=False, mesh=jmesh(n)).run(reads))
    eng = trec.RecruitmentEngine(unit, tconfig.RecruitmentConfig(**cfg),
                                 seg_len=512, device="cpu",
                                 mesh=cpu_mesh(n))
    assert eng.mesh.size == n and eng._fused.n_dev == n
    assert eng.batch % n == 0 and eng.cand_batch % n == 0
    got = _tuples(eng.run(reads))
    assert got == want
    assert got == _tuples(trec.RecruitmentEngine(
        unit, tconfig.RecruitmentConfig(**cfg), seg_len=512,
        device="cpu", mesh=None).run(reads))
    assert sum(r[3] for r in got) == 41


@pytest.mark.parametrize("n", [2, 8])
def test_decomposer_with_a_mesh(n):
    import chip_smoke as cs
    from centroflye_tpu.mono.string_decomposer import (
        MonomerDecomposer as JDec, MonomerDecomposerConfig as JCfg)
    from centroflye_tpu_torch.mono.string_decomposer import (
        MonomerDecomposer as TDec, MonomerDecomposerConfig as TCfg)
    monomers, _, genome, _ = cs.mono_fresh_world()
    rng = np.random.default_rng(n)
    reads = [(f"r{i}", add_read_noise(rng, genome[st:st + 700], 0.04))
             for i, st in enumerate(rng.integers(0, len(genome) - 700, 7))]
    want = JDec(monomers, JCfg(batch_reads=7),
                mesh=jmesh(n)).decompose(reads)
    dec = TDec(monomers, TCfg(batch_reads=7), device="cpu",
               mesh=cpu_mesh(n))
    assert dec.mesh.size == n
    got = dec.decompose(reads)
    assert got == want
    assert got == TDec(monomers, TCfg(batch_reads=7),
                       device="cpu").decompose(reads)


@pytest.mark.parametrize("n", SHARDS)
def test_read_kmer_table_under_a_mesh(n):
    rng = np.random.default_rng(70 + n)
    unit = gen_random_seq(rng, 90)
    seqs = [add_read_noise(rng, unit * int(c), 0.05)
            for c in rng.integers(1, 6, 21)]
    want = jrare.read_kmer_table(seqs, 13, batch_rows=4, mesh=jmesh(n))
    got = trare.read_kmer_table(seqs, 13, batch_rows=4, device="cpu",
                                mesh=cpu_mesh(n))
    single = trare.read_kmer_table(seqs, 13, batch_rows=4, device="cpu")
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("n", SHARDS)
def test_distance_table_under_a_mesh(n):
    rng = np.random.default_rng(80 + n)
    kcfg = dict(k=13, min_distance=1, max_distance=12, min_coverage=2,
                bottom=0.0, top=1e9)
    R, T, K = 2 * n, 10, 4
    clouds = np.where(rng.random((R, T, K)) < 0.8,
                      rng.integers(0, 50, (R, T, K)), -1).astype(np.int32)
    n_units = np.full(R, T, np.int32)
    # about 14 chunks at every n: each is a JAX multi-device program, and
    # hundreds of them queued back to back once aborted the JAX side
    chunk = 64 * n
    want = jdg.build_distance_table(
        clouds, n_units, jconfig.KmerRecruitmentConfig(**kcfg),
        entry_chunk=chunk, mesh=jmesh(n))
    tk = tconfig.KmerRecruitmentConfig(**kcfg)
    got = tdg.build_distance_table(clouds, n_units, tk, entry_chunk=chunk,
                                   device="cpu", mesh=cpu_mesh(n))
    single = tdg.build_distance_table(clouds, n_units, tk, entry_chunk=chunk,
                                      device="cpu")
    assert got[3] == int(want[3]) == single[3] > 0
    for g, w, s in zip(got[:3], want[:3], single[:3]):
        np.testing.assert_array_equal(g, np.asarray(w)[:got[3]])
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("n", SHARDS)
def test_run_unique_kmers_artifacts_under_a_mesh(tmp_path, n):
    from test_torch_unique_kmers import ARTIFACTS, _world
    unit, dec = _world(0, 0.0, 8)     # small: the JAX mesh sweep is slow
    kw = dict(k=13, bottom=0.0, top=1e9, max_distance=3, min_coverage=2)
    jdir = os.path.join(tmp_path, "jax")
    jcenx.CenXPipeline(unit, jconfig.CentroFlyeConfig(
        coverage=1, kmer_recruitment=jconfig.KmerRecruitmentConfig(**kw)),
        jdir, mesh=jmesh(n)).run_unique_kmers(dec)
    dec_fn = os.path.join(tmp_path, "decomposition.json")
    jcenx.save_decomposition(dec, dec_fn)
    from centroflye_tpu_torch.pipeline import cenx as tcenx
    tcfg = tconfig.KmerRecruitmentConfig(**kw)
    for tag, mesh in (("mesh", cpu_mesh(n)), ("single", None)):
        tcenx.run_unique_kmers(tcenx.load_decomposition(dec_fn), tcfg, 1,
                               os.path.join(tmp_path, tag), device="cpu",
                               mesh=mesh)
    for name in ARTIFACTS:
        name = name.format(c=2)
        files = [open(os.path.join(tmp_path, d, "recruited_unique_kmers",
                                   name), "rb").read()
                 for d in ("jax", "mesh", "single")]
        assert files[0] and files[0] == files[1] == files[2], name


def test_dryrun_multichip_on_cpu_devices():
    from centroflye_tpu_torch.parallel.dryrun import dryrun_multichip
    out = dryrun_multichip(4, devices=["cpu"] * 4)
    assert out["recruited"] == 4 and out["rare_kmers"] > 0
    assert out["distance_keys"] > 0 and len(out["seqpar_dist"]) == 4
    if torch.cuda.device_count() < 64:
        with pytest.raises(RuntimeError, match="cards"):
            dryrun_multichip(64)


def test_mesh_modules_run_with_jax_blocked():
    code = """
import sys
sys.modules["jax"] = None
import numpy as np, torch
from centroflye_tpu_torch.parallel import mesh, seq_parallel, distributed
from centroflye_tpu_torch.parallel.dryrun import dryrun_multichip
from centroflye_tpu_torch.pipeline.cenx import CenXPipeline
out = dryrun_multichip(2, devices=["cpu", "cpu"])
assert out["recruited"] == 2, out
m = mesh.make_mesh(2, devices=["cpu"] * 2)
t, c, n = mesh.make_kmer_count_step(m, 5, 256)(
    np.zeros((4, 16), np.int8), np.full(4, 16, np.int32))
assert int(n) == 1 and int(c[0]) == 48
assert distributed.process_count() == 1 and distributed.is_coordinator()
bad = sorted(k for k in sys.modules if k.split(".")[0] == "centroflye_tpu")
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


@pytest.mark.gpu
def test_k5_matches_plain_on_gpu_mesh_file():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K5 has no CPU mode")
    k5_against_plain_on_gpu(seed=1)
