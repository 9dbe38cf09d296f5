"""recruit.prescan_share: the share of the window's wall time spent in the
host prescan (`ops/seed_filter.host_prescan_hits`, inside
`RecruitmentEngine.run`), from the benchmark's span around each call, in
the traced run's window without the profiler. Layer: host prescan tier."""


def read(w):
    s = w.host_probe.seconds("recruit.prescan")
    return 100.0 * s / w.host_seconds if s else None
