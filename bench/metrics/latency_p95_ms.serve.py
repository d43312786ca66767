"""95th percentile (ms) of the service's latency, from a client's submit to
its future's result, over every request answered in the window (the
benchmark's own host clock)."""
import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s), 95)) * 1e3
