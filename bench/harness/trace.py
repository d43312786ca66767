"""A traced slice of a run: torch.profiler over the card, reduced to what the
per-layer metrics and the breakdown read.

The profiler runs only over a short slice after the measured window, so
the window's own numbers carry no tracing cost.  The raw kineto events are
read directly (no FunctionEvent tree: a slice holds some 10^5 events):

* busy time: the union of the device's activity intervals (kernels,
  copies, sets) inside the slice, whatever stream they ran on;
* idle gaps: the complement of that union inside the slice, each named by
  the innermost host operation under way at its middle;
* kernel launches: each ``repro_torch::<kernel>`` operator with its input
  shapes, joined to the device activities it launched by the profiler's
  correlation ids.

The method (the profiler over CPU and CUDA activity, busy and idle share,
the top device work) is ``chip_smoke.py``'s ``_profiled`` and
``_trace_summary``; the union and the joins are the benchmark's own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import heapq
import re
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "bench.traced_slice"
KERNEL_OPS = {"repro_torch::imc_eval": "imc_eval_kernel",
              "repro_torch::ga_gen_step": "ga_gen_step_kernel"}


@dataclasses.dataclass
class Launch:
    op: str  # the operator, e.g. "repro_torch::imc_eval"
    shapes: list  # its input shapes
    device_s: float  # its kernels' device time


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]  # top device activities by time
    idle_gaps: List[Tuple[str, float]]  # longest idle time by host op
    launches: List[Launch]


@contextlib.contextmanager
def traced(out: list):
    """Trace the body on CPU and CUDA; appends the ``Trace`` (or ``None``
    when the profiler cannot trace the card) to ``out``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    prof = profile(activities=[ProfilerActivity.CPU]
                   + ([ProfilerActivity.CUDA] if cuda else []), record_shapes=True,
                   experimental_config=_all_threads())
    prof.start()
    try:
        with torch.profiler.record_function(WINDOW_SPAN):
            yield
            if cuda:
                torch.cuda.synchronize()
    finally:
        prof.stop()
    out.append(summarize(prof.profiler.kineto_results.events()))


def _all_threads():
    """The profiler's option to record host operations on every thread (the
    service launches from its worker thread), where this torch has it."""
    from torch._C._profiler import _ExperimentalConfig

    try:
        return _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        return None


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def short_name(name: str) -> str:
    """A device activity's name without its argument list and templates."""
    m = re.search(r"(\w+_kernel)\b", name)
    return m.group(1) if m else name[:80]


def summarize(events) -> Optional[Trace]:
    cpu, dev = [], []
    for e in events:
        rec = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
               e.correlation_id(), e.linked_correlation_id(), e)
        if e.device_type() == torch.autograd.DeviceType.CPU:
            cpu.append(rec)
        elif not e.is_user_annotation():  # a host span mirrored on the device
            dev.append(rec)
    win = [r for r in cpu if r[0] == WINDOW_SPAN]
    if not dev or not win:
        return None
    w0, w1 = win[0][1], win[0][2]
    union = _union([(max(a, w0), min(b, w1)) for _, a, b, *_ in dev if b > w0 and a < w1])
    busy = sum(b - a for a, b in union)

    by_name: Dict[str, float] = {}
    for name, a, b, *_ in dev:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps, named by the innermost host op under way at their middle
    host = sorted((a, b, name) for name, a, b, *_ in cpu if name != WINDOW_SPAN)
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in union for x in ab] + [w1]
    active: list = []  # (-start, end, name): the latest-started op on top
    j = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(active, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while active and active[0][1] < mid:  # ended before this gap
            heapq.heappop(active)
        name = active[0][2] if active else "host: Python between operations"
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e9
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]

    ops = {r[3]: r for r in cpu if r[0] in KERNEL_OPS}
    dev_s: Dict[int, float] = {}
    for name, a, b, _, link, _ in dev:
        if link in ops and KERNEL_OPS[ops[link][0]] in name:
            dev_s[link] = dev_s.get(link, 0.0) + (b - a) / 1e9
    launches = [Launch(op=r[0], shapes=[list(s) for s in r[5].shapes()],
                       device_s=dev_s[c]) for c, r in ops.items() if c in dev_s]
    return Trace(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9, device_ops=device_ops,
                 idle_gaps=idle_gaps, launches=launches)
