"""Engine launches (``SearchEngine.launches``: one a batched GA) over the
window, per search completed in it."""


def read(run):
    if not run.searches or "launches" not in run.counters:
        return None
    return run.counters["launches"] / run.searches
