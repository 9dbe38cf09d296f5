"""The cenX pipeline on the port (`pipeline/cenx.CenXPipeline`, stages 1-6)
against the JAX package's, on tests/test_e2e_cenx.py's world and config
(`chip_smoke.fresh_world`, `fresh_config`): from the same reads file,
the port on the CPU and the JAX package (no mesh) write every artifact
byte for byte, `metrics.json` with the same keys (it holds wall times).
Also: a resume returns the same, the port runs with jax unimportable,
its CLI writes the same assembly, and its config's JSON carries the JAX
package's across. Both native libraries are built first and asserted
loaded: without its library the JAX package takes other routes."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from centroflye_tpu import config as jconfig
from centroflye_tpu import native as jnative
from centroflye_tpu.io import write_seqs
from centroflye_tpu.io.encoding import revcomp_str
from centroflye_tpu.pipeline import cenx as jcenx
from centroflye_tpu.pipeline.simulate import (add_read_noise, gen_random_seq,
                                              simulate_tandem_repeat)

import chip_smoke as cs
from centroflye_tpu_torch import config as tconfig
from centroflye_tpu_torch import native as tnative
from centroflye_tpu_torch.ops.align_path import align_path
from centroflye_tpu_torch.parallel import mesh as tmesh
from centroflye_tpu_torch.pipeline import cenx as tcenx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = [
    "centromeric_reads.fasta", "unit.fasta", "decomposition.json",
    "recruited_unique_kmers/unique_kmers_min_edge_cov_2.txt",
    "recruited_unique_kmers/unique_edges_min_edge_cov_2.txt",
    "tr_resolution/read_positions.csv",
    "tr_resolution/placement_validation.csv", "cons_unit/unit_star.fasta",
    "polishing/final_sequence_1.fasta", "polishing/final_sequence_2.fasta",
    "polishing/final_sequence_hpc_1.fasta",
    "polishing/final_sequence_hpc_2.fasta", "polishing/report.txt",
    "polishing2/polished/polished_1.fasta",
    "polishing2/polished/polished_2.fasta", "polishing2/report.txt",
    "final_assembly.fasta"]


def _jax_config():
    """tests/test_e2e_cenx.py's pipeline_cfg."""
    return jconfig.CentroFlyeConfig(
        coverage=4,
        recruitment=jconfig.RecruitmentConfig(threshold=int(150 * 0.25),
                                              batch_size=16),
        decomposition=jconfig.UnitDecompositionConfig(min_record_len=800),
        kmer_recruitment=jconfig.KmerRecruitmentConfig(
            k=13, min_distance=1, max_distance=6, min_coverage=2,
            bottom=0.0, top=1e9),
        placer=jconfig.PlacerConfig(min_cloud_kmer_freq=2, min_kmer_mult=2,
                                    min_unit=2, min_inters=5,
                                    prefix_threshold=1800,
                                    small_threshold=1000),
        consensus_unit=jconfig.ConsensusUnitConfig(k=21),
        polisher=jconfig.PolisherConfig(num_iters=2))


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for name in names:
            fn = os.path.join(d, name)
            with open(fn, "rb") as f:
                out[os.path.relpath(fn, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert jnative.load_native(build=True) is not None, \
        "the JAX package's libcfnative.so did not build"
    assert tnative.load_library() is not None
    unit, sim, reads = cs.fresh_world()
    root = str(tmp_path_factory.mktemp("cenx"))
    reads_fn = os.path.join(root, "reads.fasta")
    write_seqs(reads_fn, reads)
    jout, tout = os.path.join(root, "jax"), os.path.join(root, "port")
    jfinal = jcenx.CenXPipeline(unit, _jax_config(), jout,
                                mesh=None).run(reads_fn)
    tfinal = tcenx.CenXPipeline(unit, cs.fresh_config(), tout,
                                device="cpu").run(reads_fn)
    return dict(unit=unit, sim=sim, reads=reads, reads_fn=reads_fn,
                root=root, jax=jout, port=tout, jfinal=jfinal,
                tfinal=tfinal, jfiles=_files(jout), tfiles=_files(tout))


def test_world_and_config_are_the_e2e_tests():
    """chip_smoke.fresh_world draws tests/test_e2e_cenx.py's reads from
    the same generator, and fresh_config is its config."""
    rng = np.random.default_rng(23)
    unit = gen_random_seq(rng, 150)
    sim = simulate_tandem_repeat(rng, unit, mult=30, div_rate=0.03,
                                 flank_len=4000)
    g = sim.flanked_tr
    tr_start, tr_end = 4000, 4000 + len(sim.tr)
    reads = {}
    for pi, left in enumerate([3500, 3000, 2600]):
        reads[f"pre{pi}"] = g[tr_start - left:tr_start + 10 * 150]
    i, start = 0, tr_start + 100
    while start + 2200 < tr_end - 100:
        seq = g[start:start + 2200]
        if i % 3 == 1:
            seq = revcomp_str(seq)
        reads[f"int{i:02d}"] = seq
        start += 500
        i += 1
    for si, right in enumerate([3500, 3000]):
        reads[f"suf{si}"] = g[tr_end - 10 * 150:tr_end + right]
    for bi in range(4):
        reads[f"bg{bi}"] = gen_random_seq(rng, 3000)
    reads = {r: add_read_noise(rng, s, 0.02) for r, s in reads.items()}
    got_unit, got_sim, got_reads = cs.fresh_world()
    assert (got_unit, got_sim.tr, got_sim.flanked_tr, got_sim.all_muts) == \
        (unit, sim.tr, sim.flanked_tr, sim.all_muts)
    assert got_reads == reads
    assert cs.fresh_config().to_json() == _jax_config().to_json()


@pytest.mark.parametrize("name", ARTIFACTS)
def test_artifact_equal(runs, name):
    assert name in runs["jfiles"]
    assert runs["tfiles"].get(name) == runs["jfiles"][name]


def test_same_files_and_metrics_keys(runs):
    assert set(runs["tfiles"]) == set(runs["jfiles"]) == \
        set(ARTIFACTS) | {"metrics.json"}
    tm = json.loads(runs["tfiles"]["metrics.json"])
    jm = json.loads(runs["jfiles"]["metrics.json"])
    assert list(tm) == list(jm) == ["recruitment", "decomposition",
                                    "unique_kmers", "placement", "polishing",
                                    "tandem_polish"]
    for stage in jm:
        assert list(tm[stage]) == list(jm[stage])
        assert (tm[stage]["items"], tm[stage]["unit"]) == \
            (jm[stage]["items"], jm[stage]["unit"])


def test_assembly_matches_truth(runs):
    final, truth = runs["tfinal"], runs["sim"].tr
    assert final == runs["jfinal"]
    assert len(final) > 0.8 * len(truth)
    assert align_path(final, truth, mode="HW").dist / len(final) < 0.02
    unit_star = runs["tfiles"]["cons_unit/unit_star.fasta"].decode()
    unit_star = unit_star.split("\n")[1]
    assert align_path(unit_star, runs["unit"], mode="NW").dist <= 0.05 * 150


def test_resume_returns_the_same(runs, monkeypatch):
    """A second run on the same directory reads every stage's artifact
    back: no stage runs, the files do not change."""
    from centroflye_tpu_torch.stages import recruitment
    monkeypatch.setattr(recruitment, "RecruitmentEngine", None)
    monkeypatch.setattr(tcenx, "reconstruct_unit", None)
    monkeypatch.setattr(tcenx, "EltrPolisher", None)
    monkeypatch.setattr(tcenx, "run_final_polish", None)
    monkeypatch.setattr(tcenx, "UnitDecomposer", None)
    monkeypatch.setattr(tcenx, "recruit_unique_kmers", None)
    monkeypatch.setattr(tcenx, "ReadPlacer", None)
    again = tcenx.CenXPipeline(runs["unit"], cs.fresh_config(), runs["port"],
                               device="cpu").run(runs["reads_fn"])
    assert again == runs["tfinal"]
    assert _files(runs["port"]) == runs["tfiles"]


def test_resume_after_stage_5_equals_jax(runs, tmp_path):
    """Resume from stages 1-4's artifacts of the JAX package's run: the
    port computes stages 5 and 6 and writes the JAX package's files."""
    import shutil
    out = str(tmp_path / "resume")
    shutil.copytree(runs["jax"], out)
    for name in ARTIFACTS[7:] + ["metrics.json"]:
        os.remove(os.path.join(out, name))
    final = tcenx.CenXPipeline(runs["unit"], cs.fresh_config(), out,
                               device="cpu").run(runs["reads_fn"])
    assert final == runs["jfinal"]
    files = _files(out)
    assert {n: files[n] for n in ARTIFACTS} == \
        {n: runs["jfiles"][n] for n in ARTIFACTS}
    assert list(json.loads(files["metrics.json"])) == ["polishing",
                                                       "tandem_polish"]


def test_pipeline_runs_with_jax_blocked(runs, tmp_path):
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import chip_smoke as cs
        from centroflye_tpu_torch.io.fasta import write_seqs
        from centroflye_tpu_torch.pipeline.cenx import CenXPipeline
        unit, _, reads = cs.fresh_world()
        fn = sys.argv[1] + "/reads.fasta"
        write_seqs(fn, reads)
        final = CenXPipeline(unit, cs.fresh_config(), sys.argv[1] + "/out",
                             device="cpu").run(fn)
        assert not any(m.split(".")[0] in ("jax", "centroflye_tpu")
                       for m in sys.modules if sys.modules[m] is not None)
        print("FINAL", final)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"FINAL {runs['jfinal']}\n" in proc.stdout
    assert _files(str(tmp_path / "out")).keys() == runs["tfiles"].keys()
    with open(tmp_path / "out" / "final_assembly.fasta", "rb") as f:
        assert f.read() == runs["jfiles"]["final_assembly.fasta"]


def test_cli_writes_the_same_assembly(runs, tmp_path, capsys):
    unit_fn = str(tmp_path / "unit.fasta")
    write_seqs(unit_fn, {"unit": runs["unit"]})
    cfg_fn = str(tmp_path / "config.json")
    with open(cfg_fn, "w") as f:
        f.write(_jax_config().to_json())
    out = str(tmp_path / "out")
    tcenx.main(["-i", runs["reads_fn"], "-o", out, "-u", unit_fn, "-c", "4",
                "--config", cfg_fn, "--device", "cpu"])
    assert f"final assembly length: {len(runs['jfinal'])}" in \
        capsys.readouterr().out
    files = _files(out)
    assert {n: files[n] for n in ARTIFACTS} == \
        {n: runs["jfiles"][n] for n in ARTIFACTS}


def test_config_json_round_trip():
    """The JAX package's JSON loads into equal fields, and the port's
    to_json gives the JAX package's text, the infinite max_pos included;
    unknown keys raise in both."""
    for j, t in ((jconfig.CentroFlyeConfig(), tconfig.CentroFlyeConfig()),
                 (jconfig.CentroFlyeConfig.cen6(),
                  tconfig.CentroFlyeConfig.cen6()),
                 (_jax_config(), cs.fresh_config())):
        text = j.to_json()
        loaded = tconfig.CentroFlyeConfig.from_json(text)
        assert loaded == t
        assert dataclasses.asdict(loaded) == dataclasses.asdict(j)
        assert t.to_json() == text
        assert jconfig.CentroFlyeConfig.from_json(t.to_json()) == j
    t = tconfig.CentroFlyeConfig().replace(
        coverage=7, polisher=tconfig.PolisherConfig(max_pos=float("inf"),
                                                    num_iters=3))
    j = jconfig.CentroFlyeConfig().replace(
        coverage=7, polisher=jconfig.PolisherConfig(max_pos=float("inf"),
                                                    num_iters=3))
    assert t.to_json() == j.to_json()
    assert tconfig.CentroFlyeConfig.from_json(j.to_json()) == t
    raw = json.loads(j.to_json())
    raw["polisher"]["max_pos"] = "inf"
    assert tconfig.CentroFlyeConfig.from_json(json.dumps(raw)) == t
    for bad in ({"nope": 1}, {"placer": {"nope": 1}}):
        for cls in (tconfig.CentroFlyeConfig, jconfig.CentroFlyeConfig):
            with pytest.raises(KeyError):
                cls.from_json(json.dumps(bad))


@pytest.mark.parametrize("change", [
    dict(threads=4), dict(mono=tconfig.MonoConfig(min_k=50)),
    dict(parallel=tconfig.ParallelConfig(n_devices=4)),
    dict(polisher=tconfig.PolisherConfig(error_mode="pacbio"))],
    ids=["threads", "mono", "parallel", "error_mode"])
def test_pipeline_rejects_settings_it_does_not_run(change, tmp_path):
    """No setting that the JAX pipeline accepts is rejected: threads,
    mono and polisher.error_mode are carried and not read on the cenX
    path (as in the JAX package), and parallel.n_devices only sizes the
    automatic mesh over several cards (none on the CPU). The settings
    survive the CLI's --config JSON. What the pipeline cannot run, a
    mesh of cards for a CPU run, it rejects with the setting."""
    cfg = tconfig.CentroFlyeConfig().replace(**change)
    pipe = tcenx.CenXPipeline("ACGT", cfg, str(tmp_path), device="cpu")
    assert pipe.config == cfg and pipe.mesh is None
    assert not hasattr(tcenx, "unrun_settings")
    assert tconfig.CentroFlyeConfig.from_json(cfg.to_json()) == cfg
    cards = tmesh.Mesh(["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="cuda devices for a cpu run"):
        tcenx.CenXPipeline("ACGT", cfg, str(tmp_path), device="cpu",
                           mesh=cards)


def test_cli_runs_a_config_with_every_unread_setting_off_default(
        runs, tmp_path, capsys):
    """A JAX-written --config with threads, mono, parallel and
    polisher.error_mode all off their defaults runs through the port's
    CLI on the CPU and writes the files of the run with default
    settings."""
    jcfg = _jax_config().replace(
        threads=4, mono=jconfig.MonoConfig(min_k=50, max_uniq_cov=30),
        parallel=jconfig.ParallelConfig(data_axis="data", n_devices=4),
        polisher=dataclasses.replace(_jax_config().polisher,
                                     error_mode="pacbio"))
    default = jconfig.CentroFlyeConfig()
    for name in ("threads", "mono", "parallel"):
        assert getattr(jcfg, name) != getattr(default, name)
    assert jcfg.polisher.error_mode != default.polisher.error_mode
    unit_fn = str(tmp_path / "unit.fasta")
    write_seqs(unit_fn, {"unit": runs["unit"]})
    cfg_fn = str(tmp_path / "config.json")
    with open(cfg_fn, "w") as f:
        f.write(jcfg.to_json())
    out = str(tmp_path / "out")
    tcenx.main(["-i", runs["reads_fn"], "-o", out, "-u", unit_fn, "-c", "4",
                "--config", cfg_fn, "--device", "cpu"])
    assert f"final assembly length: {len(runs['tfinal'])}" in \
        capsys.readouterr().out
    files = _files(out)
    assert {n: files[n] for n in ARTIFACTS} == \
        {n: runs["tfiles"][n] for n in ARTIFACTS}


def test_pipeline_on_a_two_device_mesh_writes_the_same_files(runs,
                                                            tmp_path):
    """CenXPipeline with a mesh of two CPU devices (stages 1 and 3
    sharded) writes every file of the run without a mesh."""
    out = str(tmp_path / "mesh")
    pipe = tcenx.CenXPipeline(runs["unit"], cs.fresh_config(), out,
                              device="cpu",
                              mesh=tmesh.make_mesh(2, devices=["cpu"] * 2))
    assert pipe.mesh.size == 2
    assert pipe.run(runs["reads_fn"]) == runs["tfinal"]
    files = _files(out)
    assert {n: files[n] for n in ARTIFACTS} == \
        {n: runs["tfiles"][n] for n in ARTIFACTS}


def test_cuda_pipeline_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcenx.CenXPipeline("ACGT", tconfig.CentroFlyeConfig(),
                           str(tmp_path))


@pytest.mark.gpu
def test_pipeline_on_gpu_matches_cpu(runs, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pipeline's CUDA path")
    out = str(tmp_path / "card")
    final = tcenx.CenXPipeline(runs["unit"], cs.fresh_config(), out,
                               device="cuda").run(runs["reads_fn"])
    assert final == runs["tfinal"]
    files = _files(out)
    assert {n: files[n] for n in ARTIFACTS} == \
        {n: runs["tfiles"][n] for n in ARTIFACTS}
