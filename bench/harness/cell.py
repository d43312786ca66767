"""One run of one cell: set-up, warm-up, the measured window, a traced
slice (``--trace 1``), then the check, and the result's line.

The traffic's kind names the driver (``bench/drivers/<kind>.py``) that
makes the load and times the window: a sweep's rate is over whole calls, a
service's over ``[t0, t0 + seconds]``.

``setup_s`` is the time from the process's start to the window's start
(on several cards, the lead's: waiting for its followers and making the
process group included); ``memory_peak_bytes`` is the fullest card's, and
``busy_s`` / ``window_s`` the mean over the cards traced.
The traced slice comes after the window, so nothing in the window is
traced; the per-layer metrics that read host clocks and counters are taken
from the window itself.  ``device_ms_per_search``, an end-to-end metric,
reads the card's busy time over a slice that an untraced run's driver
traces after its window (the sweep's ``device_calls``).
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Optional

import numpy as np
import torch

from bench.harness import check
from bench.harness.spec import Spec


def measure(driver, traffic: dict, seconds: float, trace: bool,
            clock=time.perf_counter, window=None) -> tuple:
    """The window (and the traced slice) by the traffic kind's driver
    module's ``window``: returns (Run, the window's start)."""
    slices: list = []
    window = window or Spec().driver(traffic["kind"]).window
    run, t0 = window(driver, traffic, seconds, trace, clock, slices)
    run.traces = [s for s in slices if s is not None]
    return run, t0


def device_ms_per_search(run) -> float:
    """The card's busy time (``trace.summarize``'s ``busy_s``) over the
    slice that an untraced run's driver traced, per search made in it."""
    return sum(t.busy_s for t in run.traces) * 1e3 / run.device_searches


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *, t_start: float,
             device="cuda", chips: int = 1, control: bool = False,
             spec: Optional[Spec] = None, world=None) -> dict:
    """One run of ``cell_name``; returns the result's line as a dict.
    ``control=True`` also judges the bfloat16 control on the same answers,
    under ``out["control"]`` (``check.compare``).  ``world`` is the lead's
    ``ranks.Lead`` in a cell on several cards: this process is rank 0, and
    the followers' peaks and traced slices join its own once its side is
    closed."""
    spec = spec or Spec()
    cell = spec.cell(cell_name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_in = time.perf_counter()
    kind = spec.driver(traffic["kind"])
    driver = kind.Driver(cfg, traffic, seed, dev)
    t_built = time.perf_counter()
    driver.warmup()
    t_warm = time.perf_counter()
    run, t0 = measure(driver, traffic, seconds, trace, window=kind.window)
    setup_s = t0 - t_start
    print(f"bench: set-up phases from the process's start (s): imports and the card "
          f"{t_in - t_start:.3f}, driver built {t_built - t_start:.3f}, warm-up done "
          f"{t_warm - t_start:.3f}, window opens {setup_s:.3f}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    driver.close()
    if world is not None:
        peaks, run.follower_traces = world.collect()
        peak = max([peak, *peaks])
    answers = driver.collected()
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    limits = spec.limits(cell_name)
    numbers = check.compare(answers, cfg["workloads"], dev)
    print(f"bench: set-up {setup_s:.3f} s, window {run.window_s:.3f} s, "
          f"{run.searches} searches; the check of {numbers['answers']} answers "
          f"took {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    metrics = {}
    if not trace:
        values = {"searches_per_s": run.searches / run.window_s, "setup_s": setup_s}
        if run.device_searches and run.traces:  # none where no card was traced
            values["device_ms_per_search"] = device_ms_per_search(run)
        for m in spec.end_to_end(cell_name):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in spec.per_layer(cell_name):
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {
        "correct": check.verdict(numbers, limits),
        "attempted": run.searches + numbers["unanswered"],
        "failed": numbers["unanswered"],
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": chips, "memory_peak_bytes": int(peak)},
    }
    cards = run.traces + [t for t in run.follower_traces if t is not None]
    if trace and run.traces:
        out["device"]["busy_s"] = float(np.mean([t.busy_s for t in cards]))
        out["device"]["window_s"] = float(np.mean([t.window_s for t in cards]))
        t = run.traces[0]
        out["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                            "idle_gaps": [list(x) for x in t.idle_gaps]}
    if control:
        ctl = check.compare(answers, cfg["workloads"], dev, control=True)
        out["control"] = {k: ctl[k] for k in check.NAMES}
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NAMES}
    return out


def report_checks(out: dict, stream=sys.stderr) -> None:
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=stream)
