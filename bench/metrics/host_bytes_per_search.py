"""Bytes the engine brought to the host at its sync points
(``SearchEngine.transfer_bytes``) over the window, per search completed in
it."""


def read(run):
    if not run.searches or "transfer_bytes" not in run.counters:
        return None
    return run.counters["transfer_bytes"] / run.searches
