"""Share (%) of the traced slice in which a card other than the lead's ran
nothing but collectives (``device_idle_share`` of each of ranks 1 .. chips
- 1, which trace their cards over the lead's slice): the largest of them."""


def read(run):
    shares = [1.0 - t.busy_s / t.window_s for t in run.follower_traces if t is not None]
    return max(shares) * 100.0 if shares else None
