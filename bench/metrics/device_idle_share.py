"""Share (%) of the traced slice in which the card ran nothing: 1 minus the
union of its activity over the slice's length; the mean over the cards."""
import numpy as np


def read(run):
    if not run.traces:
        return None
    return float(np.mean([1.0 - t.busy_s / t.window_s for t in run.traces])) * 100.0
