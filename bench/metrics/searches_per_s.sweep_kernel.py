"""Searches completed per second of the window, read per layer in
``cnn4-sweep-kernel``: the end-to-end ``searches_per_s`` of the other
cells, whose runs in this cell spread wider than its bound allows (the
host's pace, PERF.md section 2)."""


def read(run):
    return run.searches / run.window_s
