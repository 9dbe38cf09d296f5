"""The port's multi-process glue (`parallel/distributed.py`) and
`recruit_file(..., distributed=True)`: read-stream and file sharding,
partial paths and the coordinator merge of the partial FASTAs, first with
the process index and count stubbed (each simulated process runs the
real distributed body against one directory), against the JAX package's
helpers under the same stubs; then one real run of 2 processes in a gloo
group joined through a file store under the test's directory. The merged
file must be the single-process file byte for byte (and the JAX
package's). The `gpu` test holds K5 against its plain version on the
card."""

import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from centroflye_tpu.io import write_seqs
from centroflye_tpu.parallel import distributed as JD
from centroflye_tpu.pipeline.simulate import add_read_noise, gen_random_seq
from centroflye_tpu.stages import recruitment as jrec

from centroflye_tpu_torch.parallel import distributed as D
from centroflye_tpu_torch.stages import recruitment as trec

from test_torch_seq_parallel import k5_against_plain_on_gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 120


def _fake_process(monkeypatch, index: int, count: int):
    monkeypatch.setattr(D, "process_index", lambda: index)
    monkeypatch.setattr(D, "process_count", lambda: count)
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: count)


def test_shard_read_files_partitions(monkeypatch):
    files = [f"f{i}" for i in range(10)]
    shards = []
    for p in range(3):
        _fake_process(monkeypatch, p, 3)
        shards.append(D.shard_read_files(files))
        assert shards[-1] == JD.shard_read_files(files)
        assert D.partial_path("out.fa") == JD.partial_path("out.fa")
    assert sorted(f for s in shards for f in s) == sorted(files)
    assert shards[0] == ["f0", "f3", "f6", "f9"]          # round robin
    assert D.partial_path("out.fa", 7) == "out.fa.part7"


def test_shard_read_stream_ordinals(monkeypatch):
    reads = [(f"r{i}", "ACGT") for i in range(7)]
    seen = {}
    for p in range(2):
        _fake_process(monkeypatch, p, 2)
        got = list(D.shard_read_stream(iter(reads)))
        assert got == list(JD.shard_read_stream(iter(reads)))
        for ordinal, (r_id, _) in got:
            assert ordinal not in seen
            seen[ordinal] = r_id
    assert seen == {i: f"r{i}" for i in range(7)}


def test_init_distributed_single_process(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert D.init_distributed() is False
    assert D.process_index() == 0 and D.process_count() == 1
    assert D.is_coordinator()
    with pytest.raises(ValueError, match="num_processes"):
        D.init_distributed("file:///nonexistent/store")


def _files(tmp_path, seed=11, n=14):
    rng = __import__("numpy").random.default_rng(seed)
    unit = gen_random_seq(rng, 150)
    reads = {}
    for i in range(n):
        reads[f"read{i:02d}"] = (add_read_noise(rng, unit * 3, 0.04)
                                 if i % 3 == 0 else gen_random_seq(rng, 600))
    reads["read01"] = reads["read01"][:300] + "nNRy" + reads["read01"][300:]
    unit_fn, reads_fn = str(tmp_path / "unit.fasta"), str(tmp_path / "r.fa")
    write_seqs(unit_fn, {"unit": unit})
    write_seqs(reads_fn, reads)
    return unit_fn, reads_fn


def test_distributed_recruit_matches_single(monkeypatch, tmp_path):
    unit_fn, reads_fn = _files(tmp_path)
    single_fn = str(tmp_path / "single.fasta")
    n_single = trec.recruit_file(unit_fn, reads_fn, single_fn, threshold=40,
                                 batch_size=8, device="cpu")
    assert n_single == 5
    dist_fn = str(tmp_path / "dist.fasta")
    for p in (1, 0):                  # the worker first, the coordinator last
        _fake_process(monkeypatch, p, 2)
        n = trec.recruit_file(unit_fn, reads_fn, dist_fn, threshold=40,
                              batch_size=8, device="cpu", distributed=True)
    assert n == n_single
    with open(single_fn) as a, open(dist_fn) as b:
        assert a.read() == b.read()
    assert not os.path.exists(dist_fn + ".part0")
    assert not os.path.exists(dist_fn + ".part1.done")


def test_merge_timeout(monkeypatch, tmp_path):
    _fake_process(monkeypatch, 0, 2)
    out = str(tmp_path / "out.fasta")
    with open(D.partial_path(out, 0), "w"):
        pass
    D.finish_partial(out)
    with pytest.raises(TimeoutError, match="part1"):
        D.merge_partial_fastas(out, timeout_s=0.2, poll_s=0.05)


WORKER = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    from centroflye_tpu_torch.parallel.distributed import (
        init_distributed, process_count)
    from centroflye_tpu_torch.stages.recruitment import recruit_file
    store, rank, unit_fn, reads_fn, out_fn = sys.argv[1:]
    assert init_distributed("file://" + store, 2, int(rank))
    assert process_count() == 2
    n = recruit_file(unit_fn, reads_fn, out_fn, threshold=40, batch_size=8,
                     device="cpu", distributed=True)
    import torch.distributed as dist
    dist.destroy_process_group()
    bad = [k for k in sys.modules if k.split(".")[0] == "centroflye_tpu"]
    assert not bad, bad
    print(n)
""")


def test_two_gloo_processes_write_the_single_process_file(tmp_path):
    unit_fn, reads_fn = _files(tmp_path, seed=12, n=20)
    want_fn = str(tmp_path / "single.fasta")
    n_single = trec.recruit_file(unit_fn, reads_fn, want_fn, threshold=40,
                                 batch_size=8, device="cpu")
    jax_fn = str(tmp_path / "jax.fasta")
    assert jrec.recruit_file(unit_fn, reads_fn, jax_fn, threshold=40,
                             batch_size=8, mesh=None) == n_single
    out_fn = str(tmp_path / "dist.fasta")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(tmp_path / "store"), str(rank),
         unit_fn, reads_fn, out_fn], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert int(outs[0][0]) == n_single > 0           # the coordinator's count
    with open(want_fn, "rb") as a, open(out_fn, "rb") as b:
        assert a.read() == b.read()
    with open(jax_fn, "rb") as a, open(out_fn, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.gpu
def test_k5_matches_plain_on_gpu_distributed_file():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K5 has no CPU mode")
    k5_against_plain_on_gpu(seed=2)
