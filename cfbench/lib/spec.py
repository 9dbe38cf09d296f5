"""The benchmark's declarations, found by name.

`BENCHMARK.json` at the checkout's root lists the configurations, cells
and metrics. Everything that belongs to one of them sits in a file of its
own under `cfbench/`, which this module finds by the name alone:

- a configuration: `configs/<config>.json`;
- a cell: `cells/<cell>.json` (the entry that runs it, the entry's
  parameters, why the cell exists);
- a traffic mix: `traffic/<mix>.json`, the parameters that the one
  generator (`lib/traffic.py`) reads;
- an entry: `entries/<entry>.py`, and its plain reference
  `reference/<entry>.py`;
- a per-layer metric: `layers/<metric>.py`.

A later change adds a cell, a configuration or a metric by adding files
and entries to `BENCHMARK.json`; no file here needs an edit for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def path(*parts: str) -> str:
    """A file of the benchmark, by its parts under `cfbench/`."""
    return os.path.join(HERE, *parts)


def read_json(fn: str):
    with open(fn) as f:
        return json.load(f)


def load_module(fn: str, name: str):
    """The Python file `fn` as a module (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, fn)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(fn)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with every file it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    entry: str
    params: dict
    end_to_end: list      # the end-to-end metrics this cell reports
    per_layer: list       # the per-layer metrics this cell reports


def load_benchmark(fn: str | None = None) -> dict:
    return read_json(fn or os.path.join(ROOT, "BENCHMARK.json"))


def reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """Whether `cell` reports `metric`: its `workloads` list names the
    cell, or, without one, the cell reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, bench: dict | None = None) -> Cell:
    bench = bench or load_benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cell = read_json(path("cells", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if reports(m, name, e2e_names)]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        config=read_json(path("configs", f"{w['config']}.json")),
        traffic_name=w["traffic"],
        traffic=read_json(path("traffic", f"{w['traffic']}.json")),
        entry=cell["entry"], params=cell.get("params", {}),
        end_to_end=e2e, per_layer=per_layer)


def entry_module(entry: str):
    return load_module(path("entries", f"{entry}.py"),
                       f"cfbench_entry_{entry}")


def reference_module(entry: str):
    return load_module(path("reference", f"{entry}.py"),
                       f"cfbench_reference_{entry}")


def layer_module(metric: str):
    return load_module(path("layers", f"{metric}.py"),
                       f"cfbench_layer_{metric.replace('.', '_')}")
