"""recruit.wall_mbp_s: bases of every read that `recruit_file` streamed,
whole calls only, over the wall time of the traced run's window without
the profiler, in Mbp/s: the stage's rate by the host's clock, which users
wait on. Runs of one cell spread too widely with the host's speed for a
bound, so it is read here beside the bounded `kernel_ms_per_gbp`. Layer:
file driver and native reader (the stage's entry point)."""


def read(w):
    return w.host_bases / 1e6 / w.host_seconds if w.host_bases else None
