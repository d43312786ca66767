"""Share (%) of the traced slice in which a card ran a collective's kernel
(NCCL's) and nothing else, which is mostly waiting for its peers
(``trace.summarize``'s ``collective_s``): the mean over every card traced,
the lead's and ranks 1 .. chips - 1's."""
import numpy as np


def read(run):
    cards = run.traces + [t for t in run.follower_traces if t is not None]
    if not cards:
        return None
    return float(np.mean([t.collective_s / t.window_s for t in cards])) * 100.0
