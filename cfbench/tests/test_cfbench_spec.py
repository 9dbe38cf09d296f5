"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, entry, reference and per-layer reader is found by name, and
every name and unit keeps to the allowed characters."""

from __future__ import annotations

import json
import os

import pytest

from cfbench.lib import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"] for m in BENCH["end_to_end"]}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "cfbench/run.py"]
    assert BENCH["paths"] == ["cfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = spec.load_cell(cell, BENCH)
    mod = spec.entry_module(c.entry)
    for fn in ("setup", "call", "check", "control", "probes"):
        assert callable(getattr(mod, fn))
    assert callable(spec.reference_module(c.entry).__dict__.get(
        "recruited" if c.entry == "recruit_file" else "decompose"))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s",
                                                 "kernel_ms_per_gbp"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(spec.layer_module(m["name"]).read)
        assert m["moves"] in {x["name"] for x in c.end_to_end}


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert spec.NAME_RE.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads"):
        got = [x["name"] for x in BENCH[kind]]
        assert len(got) == len(set(got))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs_and_cells():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("cfbench/")
        data = spec.read_json(os.path.join(spec.ROOT, c["file"]))
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert set(c["reduced"]) <= set(data) and c["reduced"] == \
            data["reduced"]
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200


def test_metrics():
    assert "setup_s" in E2E
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E and m["layer"]
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_layer_names_agree():
    """Metrics of one layer give the same `layer`, letter for letter, and
    the reader of each metric names it."""
    for m in BENCH["per_layer"]:
        src = open(spec.path("layers", f"{m['name']}.py")).read()
        assert src.startswith(f'"""{m["name"]}:'), m["name"]


def test_host_metrics_read_the_unprofiled_window():
    """The host-time metrics of a traced run come from its window without
    the profiler, the device's from the window under it."""
    from cfbench.lib.trace import Probe
    from cfbench.run import Window
    host, traced = Probe(), Probe()
    host.spans["recruit.reader"] = [(0, 2_000_000_000)]
    host.spans["recruit.prescan"] = [(0, 1_000_000_000)]
    host.counters["steps"] = 4
    traced.spans["recruit.reader"] = [(0, 9_000_000_000)]
    traced.counters["steps"] = 1
    w = Window(300_000_000, 10.0, host, 10.0, traced, None, 0.0)
    read = {m: spec.layer_module(m).read(w) for m in (
        "recruit.reader_share", "recruit.prescan_share", "decompose.step_ms",
        "recruit.wall_mbp_s", "decompose.wall_mbp_s")}
    assert read == {"recruit.reader_share": 20.0,
                    "recruit.prescan_share": 10.0,
                    "decompose.step_ms": 2500.0,
                    "recruit.wall_mbp_s": 30.0,
                    "decompose.wall_mbp_s": 30.0}


def test_kernel_clock_reads_kernels_alone():
    """`kernel_ms_per_gbp`'s intervals: a card's kernels, without copies,
    sets, mirrored host ranges or other cards' events."""
    from torch.autograd import DeviceType
    from cfbench.lib.trace import busy_union, kernel_intervals

    class Ev:
        def __init__(self, name, dev, a, d, card=0, note=False):
            self.v = (name, dev, a, d, card, note)

        def name(self): return self.v[0]
        def device_type(self): return self.v[1]
        def start_ns(self): return self.v[2]
        def duration_ns(self): return self.v[3]
        def device_index(self): return self.v[4]
        def is_user_annotation(self): return self.v[5]

    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    got = kernel_intervals([
        Ev("myers_perrow_kernel", cuda, 0, 10), Ev("k2", cuda, 5, 10),
        Ev("Memcpy HtoD (Pageable -> Device)", cuda, 30, 50),
        Ev("Memset (Device)", cuda, 90, 5), Ev("aten::add", cpu, 0, 99),
        Ev("cfbench.window", cuda, 0, 1000, note=True),
        Ev("k3", cuda, 0, 40, card=1)], [0])
    assert dict(got) == {0: [(0, 10), (5, 15)]}
    assert busy_union(got[0]) == [[0, 15]]
