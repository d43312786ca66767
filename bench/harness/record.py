"""What one run's window leaves for the per-layer metrics' readers
(``bench/metrics``)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from bench.harness import trace as tracing


@dataclasses.dataclass
class Run:
    searches: int
    window_s: float
    counters: Dict[str, float]  # changes over the window
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    wait_p95_s: Optional[float] = None
    call_s: List[float] = dataclasses.field(default_factory=list)
    traces: List[tracing.Trace] = dataclasses.field(default_factory=list)
    b1_layers: Dict[tuple, int] = dataclasses.field(default_factory=dict)


def delta(c0: dict, c1: dict) -> dict:
    return {name: c1[name] - c0[name] for name in c0}
