"""The cen6 pipeline on the port (`mono/pipeline.MonoPipeline`: its
decomposer, error correction, the monomer de Bruijn sweep, scaffolding,
pseudounit polishing) against the JAX package's, on tests/test_mono_e2e.py's
world and config (`chip_smoke.mono_fresh_world`, `mono_fresh_config`):
every file written (idb/db_k{k}.dot, idb/scaffold_graph.dot, the polished
scaffolds) byte for byte, and the assembly's contigs, scaffolds and
sequences equal. Also: the port with jax unimportable, its CLI with and
without an SD report, a manual join and auto_join off. Both native
libraries are built first and asserted loaded: without its library the
JAX package's polish takes other routes."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from centroflye_tpu import config as jconfig
from centroflye_tpu import native as jnative
from centroflye_tpu.io import write_seqs
from centroflye_tpu.mono import pipeline as jpipeline
from centroflye_tpu.mono.string_decomposer import (
    MonomerDecomposer as JDecomposer, decompose_to_monostrings)

import chip_smoke as cs
from centroflye_tpu_torch import native as tnative
from centroflye_tpu_torch.mono import pipeline as tpipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(root):
    out = {}
    for r, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(r, n), "rb") as f:
                out[os.path.relpath(os.path.join(r, n), root)] = f.read()
    return out


def _jax_config(**kw):
    return dataclasses.replace(jconfig.MonoConfig(
        **dataclasses.asdict(cs.mono_fresh_config())), **kw)


def _asm(a):
    return ([s.tolist() for s in a.scaffolds_mono], a.scaffolds_nucl,
            {k: [c.tolist() for c in v] for k, v in a.contigs_per_k.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert jnative.build_native() and jnative.native_available()
    tnative.load_library()
    monomers, syms, genome, reads = cs.mono_fresh_world()
    jsd = decompose_to_monostrings(monomers, reads.items())
    jdir = str(tmp_path_factory.mktemp("jax"))
    jasm = jpipeline.MonoPipeline(_jax_config(), outdir=jdir).run(jsd, reads)
    tdir = str(tmp_path_factory.mktemp("port"))
    pipe = tpipeline.MonoPipeline(cs.mono_fresh_config(), tdir,
                                  device="cpu")
    tsd = pipe.decompose(monomers, reads.items())
    tasm = pipe.run(tsd, reads)
    return dict(monomers=monomers, reads=reads, genome=genome, jsd=jsd,
                tsd=tsd, jasm=jasm, tasm=tasm, jfiles=_files(jdir),
                tfiles=_files(tdir), tmp=tmp_path_factory)


def test_sd_reports_equal(runs):
    j, t = runs["jsd"], runs["tsd"]
    assert list(j.monostrings) == list(t.monostrings)
    for r, m in j.monostrings.items():
        n = t.monostrings[r]
        assert (m.syms.tolist(), m.nucl.tolist(), m.strand) == \
            (n.syms.tolist(), n.nucl.tolist(), n.strand)


def test_every_file_equal(runs):
    files = runs["tfiles"]
    assert sorted(files) == sorted(runs["jfiles"])
    assert {f"idb/db_k{k}.dot" for k in range(3, 9)} | {
        "idb/scaffold_graph.dot",
        "polishing/scaffold_0/scaffold_0.fasta"} <= set(files)
    for name, data in files.items():
        assert data == runs["jfiles"][name], name


def test_assembly_equal(runs):
    assert _asm(runs["tasm"]) == _asm(runs["jasm"])
    best = max(runs["tasm"].scaffolds_nucl, key=len)
    assert len(best) >= 10 * cs.MONO_FRESH_LEN


@pytest.mark.parametrize("kw", [dict(auto_join=False),
                                dict(polish_n_iter=1, min_connections=1)],
                         ids=["no_auto_join", "one_polish"])
def test_config_variants_equal(runs, kw, tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    ja = jpipeline.MonoPipeline(_jax_config(**kw), jdir).run(
        runs["jsd"], runs["reads"])
    ta = tpipeline.MonoPipeline(
        dataclasses.replace(cs.mono_fresh_config(), **kw), tdir,
        device="cpu").run(runs["tsd"], runs["reads"])
    assert _asm(ta) == _asm(ja)
    assert _files(tdir) == _files(jdir)


def test_manual_join_equal(runs, tmp_path):
    """`join_scaffolds`, the reference's hard-coded cen6 join of two
    scaffolds, on a config that leaves two (min_uniq_len lower)."""
    kw = dict(min_uniq_len=5, auto_join=False)
    out = {}
    for name, mod, cfg, sd in (
            ("j", jpipeline, _jax_config(**kw), runs["jsd"]),
            ("t", tpipeline, dataclasses.replace(cs.mono_fresh_config(),
                                                 **kw), runs["tsd"])):
        pipe = (mod.MonoPipeline(cfg, str(tmp_path / name)) if name == "j"
                else mod.MonoPipeline(cfg, str(tmp_path / name),
                                      device="cpu"))
        out[name] = _asm(pipe.run(sd, runs["reads"], join_scaffolds=[0, 1]))
    assert out["t"] == out["j"]
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))


def test_pipeline_runs_with_jax_blocked(runs, tmp_path):
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import chip_smoke as cs
        from centroflye_tpu_torch.mono.pipeline import MonoPipeline
        monomers, _, _, reads = cs.mono_fresh_world()
        pipe = MonoPipeline(cs.mono_fresh_config(), sys.argv[1],
                            device="cpu")
        pipe.run(pipe.decompose(monomers, reads.items()), reads)
        assert not any(m.split(".")[0] in ("jax", "centroflye_tpu")
                       for m in sys.modules if sys.modules[m] is not None)
        print("DONE")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = str(tmp_path / "out")
    proc = subprocess.run([sys.executable, "-c", code, out], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "DONE" in proc.stdout
    assert _files(out) == runs["jfiles"]


def _sd_tsv(fn, records, names):
    """StringDecomposer's TSV of decomposer records (reverse monomers as
    name')."""
    n = len(names)
    with open(fn, "w") as f:
        for r_id, rows in records.items():
            for sym, st, en, rel in rows:
                name = names[sym % n] + ("'" if sym >= n else "")
                f.write(f"{r_id}\t{name}\t{st}\t{en}\t0.0\t{rel}\n")


@pytest.mark.parametrize("sd_report", [True, False],
                         ids=["sd_report", "decomposer"])
def test_cli_equal(runs, sd_report, tmp_path, capsys):
    monomers, reads = runs["monomers"], runs["reads"]
    mono_fn, reads_fn = str(tmp_path / "m.fasta"), str(tmp_path / "r.fasta")
    write_seqs(mono_fn, monomers)
    write_seqs(reads_fn, reads)
    args = ["--monomers", mono_fn, "--centromeric-reads", reads_fn,
            "--min-k", "3", "--max-k", "8", "--min-mult", "3"]
    if sd_report:
        tsv = str(tmp_path / "sd.tsv")
        _sd_tsv(tsv, JDecomposer(monomers).decompose(reads.items()),
                list(monomers))
        args += ["--sd-report", tsv]
    jpipeline.main(args + ["--outdir", str(tmp_path / "j")])
    want = capsys.readouterr().out
    tpipeline.main(args + ["--outdir", str(tmp_path / "t"),
                           "--device", "cpu"])
    assert capsys.readouterr().out == want
    assert _files(str(tmp_path / "t")) == _files(str(tmp_path / "j"))
    assert "idb/db_k8.dot" in _files(str(tmp_path / "t"))


def test_cuda_pipeline_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipeline.MonoPipeline(cs.mono_fresh_config(), str(tmp_path))


@pytest.mark.gpu
def test_pipeline_on_gpu_matches_cpu(runs, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decomposer's kernel K4")
    from centroflye_tpu_torch.ops.myers_cuda import myers_perrow
    before = myers_perrow.launches
    pipe = tpipeline.MonoPipeline(cs.mono_fresh_config(),
                                  str(tmp_path / "card"), device="cuda")
    sd = pipe.decompose(runs["monomers"], runs["reads"].items())
    assert myers_perrow.launches > before
    assert _asm(pipe.run(sd, runs["reads"])) == _asm(runs["tasm"])
    assert _files(str(tmp_path / "card")) == runs["tfiles"]
