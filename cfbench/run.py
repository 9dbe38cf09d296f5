#!/usr/bin/env python3
"""Run one cell of the benchmark of centroflye_tpu_torch once.

    python3 cfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is a workload of BENCHMARK.json; its files are found by name
(`lib/spec.py`). The run makes the cell's traffic from the seed, sets up
and warms up the cell's entry, then calls the entry for `--seconds`
seconds of whole calls (the window runs from its start to the end of the
last call), checks what the calls produced against the plain reference,
and prints one JSON line last on standard output. With --trace 0 the
metrics are the cell's end-to-end ones: `setup_s`, and
`kernel_ms_per_gbp`, the cards' kernel time over the whole window (from
torch.profiler's device activity alone) per Gbp of the window's calls.
With --trace 1 two windows run
one after the other, both with the benchmark's own wrappers: one of
`--seconds` without the profiler, for the host's spans and times, then
one of a quarter of that (whole calls) under torch.profiler, for the
device's; the metrics are the cell's per-layer ones, each from its
reader `layers/<metric>.py`.

`--control 1` also judges the control (the reference that breaks one
stated guarantee, put in the program's place) and prints its numbers on
standard error; the benchmark's own runs do not use it.

Without a CUDA device, or with fewer than the cell's chips, the run exits
with code 2 and prints no result. JAX and the JAX package can never be
imported here, and a run that finds them loaded once the window has
closed exits with code 3 and prints no result.
"""

import time

T_START = time.perf_counter()

import importlib.abc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BLOCKED = ("jax", "jaxlib", "flax", "centroflye_tpu")
# The profiled window's share of --seconds. Reading the profiler's events
# takes about three seconds a second of window in cen6.decompose.rel3
# (about 164 s after a 51-s window on an H100 host), which would bring a
# traced run near its 360-s limit.
TRACED_SHARE = 0.25


class _Blocked(importlib.abc.MetaPathFinder):
    """Refuses every module whose top-level name is blocked."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"{name} is not importable in the "
                                      "benchmark", name=name)
        return None


sys.meta_path.insert(0, _Blocked())
os.environ.setdefault("USE_FLAX", "0")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402

from cfbench.lib import spec  # noqa: E402


class NoDevice(RuntimeError):
    pass


@dataclasses.dataclass
class Ctx:
    """What an entry's set-up and check get."""

    seed: int
    config: dict
    traffic: dict
    params: dict
    device: str              # "cuda" or, in the CPU tests, "cpu"
    cards: list              # the CUDA cards the cell uses
    given_mesh: object       # a mesh that overrides the cell's (tests)
    workdir: str

    @property
    def mesh(self):
        """The program's mesh: the given one, else every card of the cell
        (the port's default "auto") on more than one card, else none."""
        if self.given_mesh is not None:
            return self.given_mesh
        return "auto" if len(self.cards) > 1 else None

    @property
    def ref_device(self) -> str:
        """Where the plain reference runs: the first card, or the CPU."""
        return "cuda:0" if self.cards else "cpu"


@dataclasses.dataclass
class Window:
    """What a per-layer reader gets. `host_bases`, `host_seconds` and
    `host_probe`: the bases of the whole calls, the wall time, spans and
    counters of the window run without the profiler (host times read
    there carry none of its overhead); `seconds`,
    `probe` and `trace`: those of the window under the profiler; and the
    card's INT32 rate."""

    host_bases: int
    host_seconds: float
    host_probe: object
    seconds: float
    probe: object
    trace: object
    int32_rate: float


def loaded_blocked() -> list:
    return sorted(k for k, v in list(sys.modules.items())
                  if v is not None and k.split(".")[0] in BLOCKED)


def workdir_for(cell: str) -> str:
    d = os.path.join(tempfile.gettempdir(), "cfbench", cell)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", mesh=None, control: bool = False) -> dict:
    """One run of `cell`: -> the result object (with `control` also the
    control's numbers under "control")."""
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise NoDevice("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell needs {cell.chips}")
    cards = list(range(cell.chips)) if device == "cuda" else []
    entry = spec.entry_module(cell.entry)
    ref = spec.reference_module(cell.entry)
    workdir = workdir_for(cell.name)
    ctx = Ctx(int(seed), cell.config, cell.traffic, cell.params, device,
              cards, mesh, workdir)
    try:
        st = entry.setup(ctx)
        for c in cards:
            torch.cuda.synchronize(c)
        setup_s = time.perf_counter() - T_START
        calls = 0

        def drive(probe, length):
            """Whole calls until `length` seconds have passed: -> (bases,
            each call's end, the window's wall time)."""
            nonlocal calls
            bases, ends = 0, []
            t0 = time.perf_counter()
            while True:
                if probe is not None:
                    with probe.span(f"{cell.entry}.call"):
                        bases += entry.call(st, calls)
                else:
                    bases += entry.call(st, calls)
                calls += 1
                ends.append(time.perf_counter() - t0)
                if ends[-1] >= length:
                    break
            for c in cards:
                torch.cuda.synchronize(c)
            return bases, ends, time.perf_counter() - t0

        # the harness's own objects out of the collector's way
        gc.collect()
        gc.freeze()
        if trace:
            from cfbench.lib.trace import Probe, Trace
            host, probe = Probe(), Probe()
            tracer = Trace(cards, probe)
            with entry.probes(ctx, st, host):
                host_bases, _, host_s = drive(host, seconds)
            with entry.probes(ctx, st, probe), tracer.window():
                bases, ends, window_s = drive(probe, TRACED_SHARE * seconds)
        elif cards:
            from cfbench.lib.trace import KernelClock
            clock = KernelClock(cards)
            with clock.window():
                bases, ends, window_s = drive(None, seconds)
        else:
            clock = None
            bases, ends, window_s = drive(None, seconds)
        found = loaded_blocked()
        if found:
            raise ImportError(f"loaded in the run: {found}")
        peak = max((torch.cuda.max_memory_allocated(c) for c in cards),
                   default=0)
        # the program's state freed before the reference runs
        if hasattr(entry, "release"):
            entry.release(st)
        gc.collect()
        if cards:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks, failed = entry.check(ctx, st, ref)
        check_s = time.perf_counter() - t_check
        ctl = entry.control(ctx, st, ref) if control else None
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    if trace:
        from cfbench.lib import roofline
        w = Window(host_bases, host_s, host, window_s, probe, tracer,
                   roofline.int32_ops_per_s(cards[0]) if cards else 0.0)
        metrics = {}
        for m in cell.per_layer:
            value = spec.layer_module(m["name"]).read(w)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        rates = {"setup_s": setup_s}
        if clock is not None and clock.seconds > 0:
            rates["kernel_ms_per_gbp"] = 1e3 * clock.seconds / (bases / 1e9)
        metrics = {m["name"]: {"value": rates[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in rates}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if cards else device,
           "count": len(cards) if cards else 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": calls, "failed": int(failed), "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = sum(tracer.busy_s) / len(tracer.busy_s)
        dev["window_s"] = tracer.window_s
        result["breakdown"] = tracer.breakdown()
    result["seconds"] = {"setup": setup_s, "window": window_s,
                         "check": check_s,
                         "calls": [b - a for a, b in zip([0.0] + ends, ends)]}
    if trace:
        result["seconds"]["host_window"] = host_s
    if ctl is not None:
        result["control"] = {k: {"value": v, "limit": lim}
                             for k, (v, lim) in ctl.items()}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    try:
        result = run(cell, args.seed, args.seconds, bool(args.trace),
                     control=bool(args.control))
    except NoDevice as e:
        print(f"cfbench: {e}; no result", file=sys.stderr)
        return 2
    except ImportError as e:
        print(f"cfbench: {e}; no result", file=sys.stderr)
        return 3
    print("cfbench: " + " ".join(f"{k} {v}" for k, v in
                                 result["seconds"].items()), file=sys.stderr)
    if "control" in result:
        for k, v in result.pop("control").items():
            print(f"control {k} {v['value']} limit {v['limit']}",
                  file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
