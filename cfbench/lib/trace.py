"""The traced run: host spans and counters taken by the benchmark's own
wrappers, and the device's timeline from `torch.profiler`.

`Probe` holds what the wrappers record: spans (label -> (start, end)
pairs in `time.perf_counter_ns`) and counters (name -> number). `Trace`
runs a window under the profiler and reduces its events to each card's
busy intervals (kernels, copies and sets), each kernel's device seconds
by name, and the cards' idle time by the innermost host span over it. The profiler's clock and the host's are tied by one
marker range that opens with the window.

Frozen copies: `busy_union` and the kernel filter of `kernel_events`
from tools/multicard_smoke.py:914-937 and :266-276 (the per-card busy
arithmetic of its `phase_overlap`).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time

MARKER = "cfbench.window"
TOP = 10


class Probe:
    """Spans and counters of one run; nothing is recorded unless a
    wrapper that holds the probe is called."""

    def __init__(self):
        self.spans = collections.defaultdict(list)
        self.counters = collections.defaultdict(float)

    @contextlib.contextmanager
    def span(self, label: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans[label].append((t0, time.perf_counter_ns()))

    def seconds(self, label: str) -> float:
        return sum(b - a for a, b in self.spans.get(label, ())) / 1e9

    def wrap(self, fn, label: str):
        """fn, its every call a span."""
        def wrapped(*a, **k):
            with self.span(label):
                return fn(*a, **k)
        return wrapped

    def wrap_iter(self, fn, label: str):
        """A generator function fn, the time inside each step of its
        iterator a span."""
        def wrapped(*a, **k):
            it = iter(fn(*a, **k))
            while True:
                t0 = time.perf_counter_ns()
                try:
                    item = next(it)
                except StopIteration:
                    self.spans[label].append((t0, time.perf_counter_ns()))
                    return
                self.spans[label].append((t0, time.perf_counter_ns()))
                yield item
        return wrapped


def busy_union(intervals):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def clipped(union, lo, hi):
    return [[max(a, lo), min(b, hi)] for a, b in union
            if min(b, hi) > max(a, lo)]


def gaps(union, lo, hi):
    """The idle intervals of a busy union within [lo, hi]."""
    out, at = [], lo
    for a, b in clipped(union, lo, hi):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def kernel_intervals(events, cards):
    """Each card's kernel intervals (ns) among raw profiler events: device
    events that are neither copies, sets nor mirrored host ranges."""
    from torch.autograd import DeviceType
    out = collections.defaultdict(list)
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.name().startswith(
                ("Memcpy", "Memset")):
            continue
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        if e.device_index() in cards:
            a = e.start_ns()
            out[e.device_index()].append((a, a + e.duration_ns()))
    return out


class KernelClock:
    """The cards' kernel time over one window, from torch.profiler's
    device activity alone (no host events are recorded, and the raw
    events are read without building the profiler's event tree).
    `seconds`: the union of each card's kernel intervals, summed over the
    cards."""

    def __init__(self, cards):
        self.cards = list(cards)
        self.seconds = 0.0

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        for c in self.cards:
            torch.cuda.synchronize(c)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            yield
            for c in self.cards:
                torch.cuda.synchronize(c)
        by_card = kernel_intervals(prof.profiler.kineto_results.events(),
                                   self.cards)
        self.seconds = sum(b - a for c in self.cards
                           for a, b in busy_union(by_card.get(c, []))) / 1e9


class Trace:
    """One window under torch.profiler on `cards` (CUDA indices).

    After the window: `window_s`, `busy_s` (each card's busy seconds),
    `kernel_s` (device seconds by kernel name), `op_s` (kernels, copies
    and sets by name), `idle_by_span` (idle seconds by the innermost host
    span over them)."""

    def __init__(self, cards, probe: Probe):
        self.cards = list(cards)
        self.probe = probe

    @contextlib.contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        for c in self.cards:
            torch.cuda.synchronize(c)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter_ns()
            with record_function(MARKER):
                yield
                for c in self.cards:
                    torch.cuda.synchronize(c)
            t1 = time.perf_counter_ns()
        self._reduce(prof.events(), t0, t1)

    def _reduce(self, events, t0_ns: int, t1_ns: int):
        from torch.autograd import DeviceType
        marker = [e for e in events if e.name == MARKER]
        if not marker:
            raise RuntimeError("the profiler recorded no window marker")
        # trace microseconds = host ns / 1e3 + offset
        offset = marker[0].time_range.start - t0_ns / 1e3
        lo, hi = t0_ns / 1e3 + offset, t1_ns / 1e3 + offset
        self.window_s = (t1_ns - t0_ns) / 1e9
        by_card = collections.defaultdict(list)
        self.kernel_s = collections.defaultdict(float)
        self.op_s = collections.defaultdict(float)
        for e in events:
            # the marker's own range is mirrored on the device's timeline
            if e.device_type != DeviceType.CUDA or e.name == MARKER:
                continue
            a, b = e.time_range.start, e.time_range.end
            if b <= a or b <= lo or a >= hi:
                continue
            by_card[e.device_index].append((a, b))
            dur = (min(b, hi) - max(a, lo)) / 1e6
            self.op_s[e.name] += dur
            if not e.name.startswith(("Memcpy", "Memset")):
                self.kernel_s[e.name] += dur
        unions = [clipped(busy_union(by_card.get(c, [])), lo, hi)
                  for c in self.cards]
        self.busy_s = [sum(b - a for a, b in u) / 1e6 for u in unions]
        self.idle_by_span = self._label_gaps(
            gaps(busy_union([iv for u in unions for iv in u]), lo, hi),
            offset)

    def _label_gaps(self, idle, offset):
        """Idle seconds by what the host was doing: each gap's time goes
        to the innermost host span over it (a call's own span where none
        of the spans inside the call is open, "outside calls" where no
        span is)."""
        calls, inner = [], []
        for label, ivs in self.probe.spans.items():
            dest = calls if label.endswith(".call") else inner
            dest += [(a / 1e3 + offset, b / 1e3 + offset, label)
                     for a, b in ivs]
        out = collections.defaultdict(float)
        for level in (sorted(inner), sorted(calls)):
            starts = [a for a, _, _ in level]
            rest = []
            for a, b in idle:
                k = max(0, bisect.bisect_right(starts, a) - 1)
                at = a
                while k < len(level) and level[k][0] < b:
                    s0, s1, label = level[k]
                    lo, hi = max(s0, at), min(s1, b)
                    if hi > lo:
                        if lo > at:
                            rest.append((at, lo))
                        out[label] += (hi - lo) / 1e6
                        at = hi
                    k += 1
                if b > at:
                    rest.append((at, b))
            idle = rest
        out["outside calls"] += sum(b - a for a, b in idle) / 1e6
        return dict(out)

    def kernel_seconds(self, *needles: str) -> float:
        """Device seconds of the kernels whose name holds any needle."""
        return sum(s for name, s in self.kernel_s.items()
                   if any(n in name for n in needles))

    def breakdown(self) -> dict:
        ops = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[f"idle under {n}", s] for n, s in idle]}
