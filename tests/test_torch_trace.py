"""The port's span-and-counter recorder (`utils/logging_utils`): off by
default and then inert; nested spans cut into disjoint self-time pieces
that add up to the outer wall time; the two benchmarked paths
(`recruit_file`, `MonomerDecomposer.decompose`) give the same outputs with
recording on and off and record every span and counter they name, with
`engine.prescan_rows` equal to the input's N-free segments and
`decomposer.steps` to the longest read's records; and recorded into the
benchmark's own sink (`cfbench/lib/trace.Probe`), the program's pieces
and the call time outside them add up to the call, and the benchmark's
idle-gap labelling gives each piece its own time."""

import time

import numpy as np
import pytest

import chip_smoke as cs
from centroflye_tpu_torch.io.encoding import revcomp_str
from centroflye_tpu_torch.mono.string_decomposer import (
    MonomerDecomposer, MonomerDecomposerConfig)
from centroflye_tpu_torch.pipeline.simulate import add_read_noise
from centroflye_tpu_torch.stages.recruitment import (recruit_file,
                                                     segment_starts)
from centroflye_tpu_torch.utils import logging_utils as lu
from cfbench.lib.trace import Probe, Trace

THRESHOLD = 40
SEG_LEN = 512
ENGINE_SPANS = ("engine.init", "engine.read", "engine.fill",
                "engine.prescan", "engine.route", "engine.launch",
                "engine.wait", "engine.write")
ENGINE_COUNTERS = ("engine.prescan_rows", "engine.candidate_rows",
                   "engine.scored_rows", "fused.filter_kernel_steps")
DECOMPOSER_SPANS = ("decomposer.cut", "decomposer.launch", "decomposer.wait",
                    "decomposer.choose", "decomposer.advance",
                    "decomposer.records")
DECOMPOSER_COUNTERS = ("decomposer.steps", "decomposer.windows",
                       "decomposer.batch_rows")


def random_seq(rng, n):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    """A unit and a reads file: tandem reads on both strands (recruited,
    through the fused step), background reads (dropped by the prescan),
    reads with N (the exact tier), an empty read and reads of several
    segments."""
    rng = np.random.default_rng(11)
    unit = random_seq(rng, 150)
    rc = revcomp_str(unit)
    reads = [("empty", "")]
    for i in range(40):
        src = unit if i % 2 else rc
        reads.append((f"t{i}", add_read_noise(rng, src * 4, 0.05)))
        reads.append((f"b{i}", random_seq(rng, int(rng.integers(50, 1600)))))
    for i in range(6):
        reads.append((f"n{i}", random_seq(rng, 300) + "N" * (5 + i)
                      + (unit if i % 2 else random_seq(rng, 150))
                      + random_seq(rng, 700)))
    d = tmp_path_factory.mktemp("trace")
    unit_fn, reads_fn = str(d / "unit.fasta"), str(d / "reads.fasta")
    with open(unit_fn, "w") as f:
        f.write(f">unit\n{unit}\n")
    with open(reads_fn, "w") as f:
        for r_id, seq in reads:
            f.write(f">{r_id}\n{seq}\n")
    return unit, reads, unit_fn, reads_fn, d


@pytest.fixture(scope="module")
def decomposer_world():
    monomers, _, genome, _ = cs.mono_fresh_world()
    m = cs.MONO_FRESH_LEN
    rng = np.random.default_rng(5)
    reads = [("exact", genome[:20 * m]),
             ("noisy", add_read_noise(rng, genome[:30 * m], 0.05)),
             ("reverse", revcomp_str(genome[:15 * m])),
             ("offset", add_read_noise(rng, genome[37:900], 0.03)),
             ("short", genome[:20]), ("empty", "")]
    dec = MonomerDecomposer(monomers, MonomerDecomposerConfig(),
                            device="cpu")
    return dec, reads


def run_recruit(files, out_name):
    _, _, unit_fn, reads_fn, d = files
    out = str(d / out_name)
    n = recruit_file(unit_fn, reads_fn, out, THRESHOLD, batch_size=16,
                     seg_len=SEG_LEN, device="cpu")
    with open(out, "rb") as f:
        return n, f.read()


class Tripwire:
    """A sink that fails on any use."""

    def __getattr__(self, name):
        raise AssertionError(f"the sink was touched: {name}")


def test_off_is_inert(reads_file, decomposer_world):
    assert lu._sink is None
    assert lu.span("engine.fill") is lu.span("decomposer.cut")
    with lu.recording(Tripwire()):
        with lu.recording(lu.Recording()) as inner:
            lu.count("x")
        assert inner.counters == {"x": 1}
    # the Tripwire recording is over: nothing reaches it
    lu.count("x", 5)
    with lu.span("outer"), lu.span("inner"):
        pass
    assert lu._sink is None and lu._open == []
    run_recruit(reads_file, "off.fasta")
    dec, reads = decomposer_world
    dec.decompose(reads)
    assert lu._sink is None and lu._open == []


def test_pieces_are_disjoint_and_sum_to_the_wall():
    rec = lu.Recording()
    with lu.recording(rec):
        t0 = time.perf_counter_ns()
        with lu.span("outer"):
            time.sleep(0.01)
            for _ in range(3):
                with lu.span("inner"):
                    time.sleep(0.005)
                    with lu.span("leaf"):
                        time.sleep(0.002)
                time.sleep(0.001)
            lu.count("loops", 3)
        wall = time.perf_counter_ns() - t0
    pieces = sorted(iv for ivs in rec.spans.values() for iv in ivs)
    assert all(a < b for a, b in pieces)
    assert all(p[1] <= q[0] for p, q in zip(pieces, pieces[1:]))
    assert len(rec.spans["outer"]) == 4 and len(rec.spans["inner"]) == 6
    assert len(rec.spans["leaf"]) == 3
    total = sum(b - a for a, b in pieces)
    assert abs(total - wall) <= 0.01 * wall
    assert rec.seconds("leaf") >= 0.006 and rec.seconds("inner") >= 0.015
    assert rec.counters == {"loops": 3}


def test_outputs_equal_with_recording_on_and_off(reads_file,
                                                 decomposer_world):
    off = run_recruit(reads_file, "off.fasta")
    with lu.recording(lu.Recording()):
        on = run_recruit(reads_file, "on.fasta")
    assert on == off and off[0] > 10
    dec, reads = decomposer_world
    want = dec.decompose(reads)
    with lu.recording(lu.Recording()):
        got = dec.decompose(reads)
    assert got == want and len(want["noisy"]) > 20


def n_free_segments(seqs, m):
    overlap = m + THRESHOLD - 1
    seg = max(SEG_LEN, overlap + m)
    n = 0
    for s in seqs:
        for st in segment_starts(len(s), seg, overlap):
            piece = s[st:st + min(seg, len(s) - st)]
            n += not set(piece) - set("ACGT")
    return n


def test_recruit_file_records_its_spans_and_counters(reads_file):
    unit, reads, *_ = reads_file
    rec = lu.Recording()
    with lu.recording(rec):
        n, _ = run_recruit(reads_file, "on.fasta")
    assert set(ENGINE_SPANS) <= set(rec.spans)
    assert set(rec.counters) == set(ENGINE_COUNTERS)
    assert rec.counters["engine.prescan_rows"] == n_free_segments(
        [s for _, s in reads], len(unit))
    # the tandem segments pass to the fused step, most others do not
    assert n <= rec.counters["engine.candidate_rows"] < \
        rec.counters["engine.prescan_rows"] / 2
    # every tandem read passes the fused step's filter with a segment
    assert 40 <= rec.counters["engine.scored_rows"] <= \
        rec.counters["engine.candidate_rows"]
    # every fused step of the engine takes the packed filter path, with
    # at most a candidate batch (256 rows) a step
    cand = rec.counters["engine.candidate_rows"]
    assert -(-cand // 256) <= rec.counters["fused.filter_kernel_steps"] \
        <= cand
    assert len(rec.spans["engine.read"]) == len(reads) + 1   # + the end
    assert len(rec.spans["engine.fill"]) >= len(reads)
    assert len(rec.spans["engine.write"]) == n


def test_decompose_records_its_spans_and_counters(decomposer_world):
    dec, reads = decomposer_world
    rec = lu.Recording()
    with lu.recording(rec):
        out = dec.decompose(reads)
    assert set(DECOMPOSER_SPANS) <= set(rec.spans)
    assert set(rec.counters) == set(DECOMPOSER_COUNTERS)
    steps = rec.counters["decomposer.steps"]
    assert steps == max(len(r) for r in out.values())
    assert rec.counters["decomposer.windows"] == sum(map(len, out.values()))
    assert rec.counters["decomposer.batch_rows"] == steps * len(reads)
    assert len(rec.spans["decomposer.records"]) == 1


def call_in_probe(call, label):
    """One window of the benchmark's drive loop around one call, with the
    program recording into the benchmark's sink: -> (probe, window
    start, window end) in perf_counter_ns."""
    probe = Probe()
    with lu.recording(probe):
        t0 = time.perf_counter_ns()
        with probe.span(label):
            call()
        t1 = time.perf_counter_ns()
    return probe, t0, t1


@pytest.mark.parametrize("which", ["recruit", "decompose"])
def test_pieces_in_the_benchmarks_probe(which, reads_file,
                                        decomposer_world):
    if which == "recruit":
        label, prefix = "recruit_file.call", "engine."
        probe, t0, t1 = call_in_probe(
            lambda: run_recruit(reads_file, "probe.fasta"), label)
    else:
        dec, reads = decomposer_world
        label, prefix = "decompose.call", "decomposer."
        probe, t0, t1 = call_in_probe(lambda: dec.decompose(reads), label)
    window_s = (t1 - t0) / 1e9
    names = [n for n in probe.spans if n.startswith(prefix)]
    shares = {n: 100 * probe.seconds(n) / window_s for n in names}
    untraced = 100 * (probe.seconds(label) - sum(
        probe.seconds(n) for n in names)) / window_s
    assert untraced >= 0
    assert abs(sum(shares.values()) + untraced - 100) <= 1
    # the benchmark's idle-gap labelling over one gap as long as the
    # window gives each piece its own time, and the call what no piece
    # covers
    idle = Trace([], probe)._label_gaps([(t0 / 1e3, t1 / 1e3)], 0.0)
    for n in names:
        assert idle[n] == pytest.approx(probe.seconds(n), rel=1e-6,
                                        abs=1e-6)
    assert idle[label] == pytest.approx(untraced * window_s / 100,
                                        rel=1e-6, abs=1e-6)
