"""Bytes the lead's collectives brought in (``core.distributed.STATS.bytes``
of rank 0: the plans it broadcasts, the results and seed pools it
all-gathers) over the window, per search completed in it."""


def read(run):
    if not run.searches or "collective_bytes" not in run.counters:
        return None
    return run.counters["collective_bytes"] / run.searches
