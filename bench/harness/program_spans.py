"""The program's own spans (``repro_torch.spans``), for the per-layer
metrics that read them.

A span records only while a profiler runs, so after a ``--trace 1`` run the
registry holds the traced slice's spans, and a little more: the profiler's
stop holds the interpreter for a second or more while it collects its
events, and a span that another thread (the service's worker) had open
then lasts as long, ending after the slice.  So the spans are summed from
``repro_torch.spans.records()``, keeping those that end within the slice's
length (``Trace.window_s``) of the first one's start.  Where the program
has no spans (a tree older than them) or recorded none, every reading is
``None`` and the metric is left out of the line.  "A launch" is one
``engine.dispatch`` span.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple


def sums(run) -> Optional[Dict[str, Tuple[int, float]]]:
    """Per span name, (count, inclusive seconds) over the traced slice, or
    ``None`` where there is nothing to read."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    recs = spans.records()
    if not recs:
        return None
    traces = getattr(run, "traces", None)
    if traces:
        end = min(r.start_ns for r in recs) + int(traces[0].window_s * 1e9)
        recs = [r for r in recs if r.start_ns + r.dur_ns <= end]
    out: Dict[str, Tuple[int, float]] = {}
    for r in recs:
        n, s = out.get(r.name, (0, 0.0))
        out[r.name] = (n + 1, s + r.dur_ns / 1e9)
    return out


def per_launch(run, name: str, count: bool = False) -> Optional[float]:
    """Span ``name``'s inclusive ms (or, with ``count``, its number) over the
    slice's launches; 0 where it never ran in a slice with launches."""
    s = sums(run)
    launches = (s or {}).get("engine.dispatch", (0, 0.0))[0]
    if not launches:
        return None
    n, total = s.get(name, (0, 0.0))
    return (n if count else total * 1e3) / launches


def mean_ms(run, name: str) -> Optional[float]:
    """Mean inclusive ms of one span ``name`` in the slice."""
    n, total = (sums(run) or {}).get(name, (0, 0.0))
    return total * 1e3 / n if n else None
