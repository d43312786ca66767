"""The lead's collective calls (``core.distributed.STATS.calls`` of rank 0)
over the window, per engine launch in it (``SearchEngine.launches``: one an
``engine.dispatch``)."""


def read(run):
    if not run.counters.get("launches") or "collective_calls" not in run.counters:
        return None
    return run.counters["collective_calls"] / run.counters["launches"]
