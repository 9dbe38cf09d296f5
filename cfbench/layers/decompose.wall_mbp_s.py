"""decompose.wall_mbp_s: bases of the reads that
`MonomerDecomposer.decompose` turned into monomer calls, whole calls
only, over the wall time of the traced run's window without the
profiler, in Mbp/s: the stage's rate by the host's clock, which users
wait on. Runs of one cell spread too widely with the host's speed for a
bound, so it is read here beside the bounded `kernel_ms_per_gbp`. Layer:
decomposer host steps."""


def read(w):
    return w.host_bases / 1e6 / w.host_seconds if w.host_bases else None
