"""The port on several cards of one host: a process's card
(`parallel/distributed.local_device`, and `init_distributed` making it
current), mesh="auto" in a multi-process run (no mesh: each process
works on its own card), the wrappers' launch counts by card, and
tools/multicard_smoke.py, the four-card drive, at a small size on four
CPU devices phase by phase (every equality check holds, with jax
blocked) and refusing to run without four cards. The `gpu` test holds
every kernel against its plain version on each of four cards, each
launched while another card is current."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from centroflye_tpu_torch.ops import myers_cuda
from centroflye_tpu_torch.parallel import distributed as D
from centroflye_tpu_torch.parallel import mesh as M

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "tools", "multicard_smoke.py")
JOIN_TIMEOUT_S = 120
SMOKE_TIMEOUT_S = 600


def _cards(monkeypatch, n, available=True):
    """The host seen as n cards; set_device calls recorded."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    calls = []
    monkeypatch.setattr(torch.cuda, "set_device", calls.append)
    return calls


def _processes(monkeypatch, rank, count, local_rank=None):
    monkeypatch.setattr(D, "process_index", lambda: rank)
    monkeypatch.setattr(D, "process_count", lambda: count)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", str(local_rank))


@pytest.mark.parametrize("rank, count, local_rank, cards, want", [
    (6, 8, 2, 4, 2),          # LOCAL_RANK given: it, not the rank
    (5, 8, None, 4, 1),       # the rank only: rank % cards
    (3, 4, None, 2, 1),       # more processes than cards: round robin
    (1, 2, 1, 1, 0),          # one card: every process on it
])
def test_local_device(monkeypatch, rank, count, local_rank, cards, want):
    _cards(monkeypatch, cards)
    _processes(monkeypatch, rank, count, local_rank)
    assert D.local_device() == torch.device("cuda", want)
    # "cuda" without an index is the process's card in such a run
    assert M._device("cuda") == torch.device("cuda", want)
    assert M._device("cuda:3") == torch.device("cuda", 3)


def test_local_device_needs_a_card(monkeypatch):
    _cards(monkeypatch, 0, available=False)
    _processes(monkeypatch, 0, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        D.local_device()


def test_auto_mesh_single_and_multi_process(monkeypatch):
    _cards(monkeypatch, 4)
    _processes(monkeypatch, 0, 1)
    mesh = M.resolve_mesh("auto", "cuda")
    assert [str(d) for d in mesh.devices] == [f"cuda:{i}" for i in range(4)]
    _processes(monkeypatch, 1, 4, local_rank=1)
    assert M.auto_mesh() is None
    assert M.resolve_mesh("auto", "cuda") is None
    assert M.resolve_mesh("auto", "cpu") is None
    # an explicit mesh is still honoured
    given = M.make_mesh(2, devices=["cuda:2", "cuda:3"])
    assert M.resolve_mesh(given, "cuda") is given


def test_init_distributed_binds_the_card(monkeypatch):
    calls = _cards(monkeypatch, 4)
    _processes(monkeypatch, 6, 8, local_rank=3)
    monkeypatch.setattr(D, "_active", lambda: True)
    assert D.init_distributed() is True
    assert calls == [torch.device("cuda", 3)]
    # without CUDA the CPU path is unchanged: no card is bound
    calls = _cards(monkeypatch, 0, available=False)
    assert D.init_distributed() is True and calls == []
    # a single process binds nothing
    calls = _cards(monkeypatch, 4)
    _processes(monkeypatch, 0, 1)
    assert D.init_distributed() is False and calls == []


def test_launch_counts_by_card():
    w = myers_cuda.myers_hw_2strand
    myers_cuda.reset_launches()
    assert w.launches == 0 and w.launches_by_device == {}
    for i in (2, 0, 2):
        myers_cuda._count(w, torch.device("cuda", i))
    assert w.launches == 3 and w.launches_by_device == {2: 2, 0: 1}
    myers_cuda.reset_launches(w)
    assert w.launches == 0 and w.launches_by_device == {}
    assert set(myers_cuda.WRAPPERS) == {
        myers_cuda.myers_hw_2strand, myers_cuda.myers_hw_v3,
        myers_cuda.myers_hw_v3_banded, myers_cuda.myers_perrow,
        myers_cuda.myers_carry, myers_cuda.myers_hw_chunks}
    for w in myers_cuda.WRAPPERS:
        assert w.launches_by_device == {}


WORKER = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None
    import torch
    # the host seen as 4 cards: the binding and "auto" are what is held
    torch.cuda.is_available = lambda: True
    torch.cuda.device_count = lambda: 4
    bound = []
    torch.cuda.set_device = bound.append
    from centroflye_tpu_torch.parallel import mesh
    from centroflye_tpu_torch.parallel.distributed import (
        init_distributed, local_device)
    from centroflye_tpu_torch.stages.recruitment import recruit_file
    store, rank, unit_fn, reads_fn, out_fn = sys.argv[1:]
    assert init_distributed("file://" + store, 2, int(rank))
    auto = (mesh.auto_mesh() is None
            and mesh.resolve_mesh("auto", "cuda") is None)
    local = str(local_device())
    n = recruit_file(unit_fn, reads_fn, out_fn, threshold=40, batch_size=8,
                     device="cpu", distributed=True)
    import torch.distributed as dist
    dist.destroy_process_group()
    bad = [k for k in sys.modules if k.split(".")[0] == "centroflye_tpu"]
    assert not bad, bad
    print(json.dumps({"n": n, "bound": [str(d) for d in bound],
                      "local": local, "auto_cuda": auto}))
""")


def test_two_processes_bind_their_cards_and_shard_nothing(tmp_path):
    from centroflye_tpu_torch.io.fasta import write_seqs
    from centroflye_tpu_torch.pipeline.simulate import (add_read_noise,
                                                        gen_random_seq)
    from centroflye_tpu_torch.stages import recruitment as trec
    rng = np.random.default_rng(13)
    unit = gen_random_seq(rng, 150)
    reads = {f"read{i:02d}": add_read_noise(rng, unit * 3, 0.04)
             if i % 3 == 0 else gen_random_seq(rng, 600) for i in range(18)}
    unit_fn, reads_fn = str(tmp_path / "unit.fa"), str(tmp_path / "r.fa")
    write_seqs(unit_fn, {"unit": unit})
    write_seqs(reads_fn, reads)
    want_fn = str(tmp_path / "single.fasta")
    n_single = trec.recruit_file(unit_fn, reads_fn, want_fn, threshold=40,
                                 batch_size=8, device="cpu")
    out_fn = str(tmp_path / "dist.fasta")
    procs = []
    for rank in range(2):
        # LOCAL_RANK, where given, decides the card, not the rank
        env = dict(os.environ, PYTHONPATH=REPO, LOCAL_RANK=str(1 - rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp_path / "store"),
             str(rank), unit_fn, reads_fn, out_fn], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    for rank, g in enumerate(got):
        assert g["bound"] == [f"cuda:{1 - rank}"]
        assert g["local"] == f"cuda:{1 - rank}"
        assert g["auto_cuda"]
    assert got[0]["n"] == n_single > 0
    with open(want_fn, "rb") as a, open(out_fn, "rb") as b:
        assert a.read() == b.read()


RUN_SMOKE = textwrap.dedent("""
    import runpy, sys
    sys.modules["jax"] = None
    sys.argv = sys.argv[1:]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        bad = [k for k in sys.modules
               if k.split(".")[0] == "centroflye_tpu"]
        assert not bad, bad
""")


def _smoke(*args, env=None):
    return subprocess.run(
        [sys.executable, "-c", RUN_SMOKE, SMOKE, *args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, **(env or {})),
        capture_output=True, text=True, timeout=SMOKE_TIMEOUT_S)


@pytest.mark.parametrize("phases", [
    "kernels_per_card", "engine,overlap", "seqpar", "distributed",
    "dryrun", "cen6", "cenx"])
def test_multicard_smoke_on_four_cpu_devices(phases):
    proc = _smoke("--device", "cpu", "--phases", phases)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    last = lines[-1]
    assert last["ok"] is True and last["cards"] == 4
    assert last["phases"] == phases.split(",")
    got = {ln["phase"] for ln in lines[:-1]}
    assert set(phases.split(",")) <= got
    by = {ln["phase"]: ln for ln in lines[:-1]}
    if "kernels_per_card" in by:
        cards = by["kernels_per_card"]["cards"]
        assert [c["card"] for c in cards] == [0, 1, 2, 3]
        assert all(set(c["max_abs_err"].values()) == {0} for c in cards)
    if "engine" in by:
        assert by["engine"]["equal"] and by["engine"]["recruited"] > 0
        assert all(r["seqpar_reads"] > 0
                   for r in by["engine"]["runs"].values())
    if "seqpar" in by:
        assert by["seqpar"]["held_launch"]["max_abs_err"] == 0
        assert by["seqpar"]["launches_captured"] > 0
    if "distributed" in by:
        assert by["distributed"]["identical"]
        assert len(by["distributed"]["workers"]) == 4
    if "cen6" in by:
        assert by["cen6"]["sd_equal"] and by["cen6"]["identical_file"]
    if "cenx" in by:
        assert by["cenx"]["stage3_identical"]
        assert by["cenx"]["devices"] == ["cpu"] * 4


def test_multicard_smoke_refuses_without_four_cards():
    proc = _smoke("--phases", "dryrun", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "cuda" in proc.stderr.lower()


@pytest.mark.parametrize("cards", [1, 2, 3])
def test_multicard_smoke_refuses_fewer_cards(monkeypatch, cards):
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import multicard_smoke as mc
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(SystemExit, match=f"{cards} CUDA device"):
        mc.phase_cards(mc.Run("cuda"))


@pytest.mark.gpu
def test_every_kernel_on_each_of_four_cards():
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs: the kernels have no CPU mode")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import multicard_smoke as mc
    finally:
        sys.path.pop(0)
    for card in range(4):
        got = mc.card_worker(card, "cuda")
        assert set(got["max_abs_err"].values()) == {0}, got
        for counts in got["launches_by_card"].values():
            assert list(counts) == [card] and counts[card] > 0
