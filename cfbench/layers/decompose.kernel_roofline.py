"""decompose.kernel_roofline: K4's share of its roofline over the window.

Work: 11 INT32 operations a query word a column over every step's real
windows x queries x columns (`lib/roofline.perrow_work`, chip_smoke's
`perrow_bound`), counted by the benchmark's wrapper from each step's
host arrays; bytes: read once and written once. Time: K4's
(`myers_perrow_kernel`) device seconds in the profiler's trace. Bound:
the larger of operations over the INT32 rate and bytes over HBM's.
Layer: kernels (K4)."""

from cfbench.lib import roofline


def read(w):
    got = roofline.share(w.probe.counters["k4_ops"],
                         w.probe.counters["k4_bytes"], w.int32_rate,
                         w.trace.kernel_seconds("myers_perrow"))
    return got[0] if got else None
