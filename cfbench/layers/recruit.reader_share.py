"""recruit.reader_share: the share of the window's wall time spent inside
the native reader's iterator (`native.native_iter_seqs`, as
`recruit_file` calls it), from the benchmark's span around each step of
it, in the traced run's window without the profiler. Layer: file driver
and native reader."""


def read(w):
    s = w.host_probe.seconds("recruit.reader")
    return 100.0 * s / w.host_seconds if s else None
