"""The port's machine-read timing: stage seconds in `metrics.json`, and
spans and counters inside a stage.

Every pipeline stage runs under `MetricsRegistry.stage`, which records
wall-clock seconds, an item count and their rate, and rewrites
`metrics.json` in the run's output directory with the same keys as the
JAX package's.

Inside a stage, `span(name)` marks a phase and `count(name, n)` adds to a
counter. Both do nothing unless `recording(sink)` is active, and then go
to `sink`: any object with `spans` (name -> list of (start_ns, end_ns))
and `counters` (name -> number), such as `Recording`. Times are
`time.perf_counter_ns`. Spans nest, and the recorder writes each one's
self time: opening a span ends the open piece of the span around it, and
closing it starts a new piece of that span. So a name's pieces never
overlap the pieces of another name, and their sum is the name's self
time. A span must close in the frame that opened it, before any `yield`.
One thread records at a time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import logging
import os
import time
from time import perf_counter_ns
from typing import Dict, Optional

logger = logging.getLogger("centroflye_tpu_torch")


@dataclasses.dataclass
class StageMetrics:
    name: str
    wall_s: float = 0.0
    items: int = 0
    unit: str = "items"

    @property
    def rate(self) -> float:
        return self.items / self.wall_s if self.wall_s > 0 else 0.0


class MetricsRegistry:
    """Per-run metrics sink; write() persists a JSON artifact."""

    def __init__(self, outdir: Optional[str] = None):
        self.outdir = outdir
        self.stages: Dict[str, StageMetrics] = {}

    @contextlib.contextmanager
    def stage(self, name: str, unit: str = "items"):
        m = self.stages.setdefault(name, StageMetrics(name=name, unit=unit))
        logger.info("stage %s: start", name)
        t0 = time.perf_counter()
        try:
            yield m
        finally:
            m.wall_s += time.perf_counter() - t0
            logger.info("stage %s: done in %.2fs (%d %s, %.1f %s/s)",
                        name, m.wall_s, m.items, m.unit, m.rate, m.unit)
            self.write()

    def write(self):
        if not self.outdir:
            return
        os.makedirs(self.outdir, exist_ok=True)
        payload = {
            name: {"wall_s": m.wall_s, "items": m.items, "unit": m.unit,
                   "rate": m.rate}
            for name, m in self.stages.items()
        }
        with open(os.path.join(self.outdir, "metrics.json"), "w") as f:
            json.dump(payload, f, indent=2)


# -- spans and counters ------------------------------------------------------

class Recording:
    """A sink: each span's self-time pieces and each counter's total."""

    def __init__(self):
        self.spans = collections.defaultdict(list)
        self.counters = collections.defaultdict(int)

    def seconds(self, name: str) -> float:
        """The self time of span `name`."""
        return sum(b - a for a, b in self.spans.get(name, ())) / 1e9


_sink = None        # where spans and counters go; None: recording is off
_open: list = []    # names of the open spans, innermost last
_since = 0          # start of the innermost open span's current piece


def _piece(name: str, start: int, end: int):
    if end > start:
        spans = _sink.spans
        pieces = spans.get(name)
        if pieces is None:
            pieces = spans[name] = []
        pieces.append((start, end))


class _Span:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _since
        now = perf_counter_ns()
        if _open:
            _piece(_open[-1], _since, now)
        _open.append(self.name)
        _since = now

    def __exit__(self, *exc):
        global _since
        now = perf_counter_ns()
        _piece(_open.pop(), _since, now)
        _since = now


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def span(name: str):
    """A context that records its time as span `name` of the active
    recording; with none, one shared context that does nothing."""
    if _sink is None:
        return _OFF
    return _Span(name)


def count(name: str, n=1):
    """Adds `n` to counter `name` of the active recording, if any."""
    if _sink is None:
        return
    counters = _sink.counters
    counters[name] = counters.get(name, 0) + n


@contextlib.contextmanager
def recording(sink):
    """Records spans and counters into `sink` inside the block; the
    recording (or none) that was active before resumes after it."""
    global _sink, _open, _since
    now = perf_counter_ns()
    if _open:
        _piece(_open[-1], _since, now)
    saved = _sink, _open
    _sink, _open = sink, []
    try:
        yield sink
    finally:
        _sink, _open = saved
        _since = perf_counter_ns()
