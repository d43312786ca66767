"""Median (ms) of one sweep call in the window (the benchmark's span around
joint_search_batched, separate_search and rescore_designs)."""
import numpy as np


def read(run):
    return float(np.median(run.call_s)) * 1e3 if run.call_s else None
