"""95th percentile (ms) of the service's queue wait (submit to dispatch),
``ServiceStats.wait_p(95)`` read as the window closes (the service keeps
its last 4096 samples)."""


def read(run):
    return None if run.wait_p95_s is None else run.wait_p95_s * 1e3
