"""decompose.step_ms: the window's wall time over its lockstep steps (one
device call a step, counted by the benchmark's wrapper around
`MonomerDecomposer._device_batch`; one K4 launch a step on one card), in
the traced run's window without the profiler. Layer: decomposer host
steps."""


def read(w):
    steps = w.host_probe.counters["steps"]
    return 1e3 * w.host_seconds / steps if steps else None
