"""recruit.kernel_roofline: the share of the roofline reached by the
kernels that answer the threshold question `dist <= k` (K1 in the fused
step and the exact tier, K3, K5 in the sequence-parallel tier), summed
over the window.

Work: the threshold search's, counted by the benchmark's wrappers from
each launch's real rows and columns (the fused step's passing rows, the
exact tier's rows, the sequence-parallel tier's reads), per strand, on
the first k + 1 query rows as words: ceil(351 / 32) = 11 for DXZ1 at
350, ceil(551 / 32) = 18 for D6Z1 at 550 (`lib/roofline.threshold_work`).
Time: those kernels' device seconds in the profiler's trace. Bound: the
larger of operations over the card's INT32 rate and bytes over HBM's.
Layer: kernels (the fused step's search)."""

from cfbench.lib import roofline

KERNELS = ("myers_hw_wavefront", "banded_", "myers_carry")


def read(w):
    got = roofline.share(w.probe.counters["threshold_ops"],
                         w.probe.counters["threshold_bytes"], w.int32_rate,
                         w.trace.kernel_seconds(*KERNELS))
    return got[0] if got else None
