"""The paper's Fig. 2 sweep, call after call (``core.search``).

One call is what ``launch/search.py --seeds N --separate`` does: the joint
search over the whole workload set batched over N seeds
(``joint_search_batched``), then for each seed the separate searches, one
per workload, batched (``separate_search``), and each separate winner's
top designs re-scored on the whole set (``rescore_designs``).  A call is
N * (1 + W) searches.

The traffic file's ``engine`` and ``request`` objects are passed unchanged
as keywords to ``SearchEngine`` and to both search calls.

The window runs whole calls back to back from its start and closes at the
first call boundary past ``seconds``; the rate is the searches of those
calls over the time from the first call's start to the last call's end.
A mix with ``device_calls`` traces that many calls after the window of an
untraced run, for ``device_ms_per_search``: calls -2, -3, ..., the same
work for one seed whatever the window's length.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np

from bench.harness import trace as tracing
from bench.harness import traffic as tr
from bench.harness.check import Answer
from bench.harness.record import Run, delta


def stream_seeds(seed: int, n: int) -> List[int]:
    """The seeds of the ``n`` searches of ``separate_search(seed)``: the
    program defines them as ``SeedSequence(seed).generate_state(n)``
    (``core.search.split_seed``), 32-bit words, so two call seeds can share
    one workload's stream, a few runs in a thousand of ``lm3-sweep-table``
    (call seeds 1654655367 and 1654653915 share qwen2-vl-2b's).  Two
    answers of one stream are one search's, not a copy."""
    return [int(x) for x in np.random.SeedSequence(int(seed)).generate_state(n)]


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.core.engine import SearchEngine

        self.device = device
        self.search = cfg["search"]
        self.calls = tr.Calls(traffic, seed)
        self.names = tuple(cfg["workloads"])
        self.ws = tr.workload_sets(cfg, [self.names])[self.names]
        self.engine = SearchEngine(device=device, **{
            "direct_seed": bool(self.search["direct_seed"]), **traffic.get("engine", {})})
        self.kw = dict(objective=self.search["objective"],
                       area_constr=float(self.search["area_mm2"]),
                       pop_size=int(self.search["pop_size"]),
                       generations=int(self.search["generations"]),
                       top_k=int(self.search["top_k"]), device=device, engine=self.engine,
                       **traffic.get("request", {}))
        self.answers: List[Answer] = []
        self.call_s: List[float] = []
        n, W, L = self.calls.n, len(self.names), int(self.ws.feats.shape[1])
        layers = sum(len(t) for t in cfg["workloads"].values())
        # the unmasked layers of an imc_eval launch of each shape this
        # sweep makes: (B, W, L) -> sum over its searches of their layers
        self.b1_layers = {(n, W, L): n * layers, (W, 1, L): layers}
        self.per_call = n * (1 + W)

    def call(self, c: int, keep: bool = True) -> int:
        """Run call ``c``; returns the searches it made."""
        from repro_torch.core.search import joint_search_batched, rescore_designs, separate_search

        joint_seeds, sep_seeds = self.calls[c]
        t0 = time.perf_counter()
        joint = joint_search_batched(joint_seeds, self.ws, **self.kw)
        seps = [separate_search(s, self.ws, **self.kw) for s in sep_seeds]
        rescored = []
        for sep in seps:
            for r in sep.values():
                if len(r.top_genomes):
                    s_all, _ = rescore_designs(r.top_genomes, self.ws,
                                               objective=self.kw["objective"],
                                               area_constr=self.kw["area_constr"],
                                               device=self.device)
                    rescored.append((r.top_genomes, s_all))
        self.call_s.append(time.perf_counter() - t0)
        if keep:
            a = dict(objective=self.kw["objective"], area=self.kw["area_constr"],
                     top_k=self.kw["top_k"])
            self.answers += [Answer(names=self.names, result=r, seed=s, **a)
                             for s, r in zip(joint_seeds, joint)]
            self.answers += [Answer(names=(n,), result=r, seed=w_seed, **a)
                             for s, sep in zip(sep_seeds, seps)
                             for w_seed, (n, r) in zip(stream_seeds(s, len(sep)), sep.items())]
            self.answers += [Answer(names=self.names, rescore=True, genomes=g, scores=s, **a)
                             for g, s in rescored]
        return self.per_call

    def warmup(self) -> None:
        self.call(-1, keep=False)
        self.call_s.clear()

    def counters(self) -> Dict[str, float]:
        return {"launches": self.engine.launches,
                "transfer_bytes": self.engine.transfer_bytes}

    def collected(self) -> List[Answer]:
        return self.answers

    def close(self) -> None:
        pass


def window(driver, traffic: dict, seconds: float, trace: bool, clock, slices: list) -> tuple:
    """Whole calls from the window's start; the traced slice
    (``trace_calls`` calls) follows it.  Returns (Run, the window's start)."""
    c0 = driver.counters()
    t0 = clock()
    searches, calls = 0, 0
    while True:
        searches += driver.call(calls)
        calls += 1
        if clock() - t0 >= seconds:
            break
    window_s = clock() - t0
    c1 = driver.counters()
    call_s = list(driver.call_s)
    device_searches = 0
    if not trace and int(traffic.get("device_calls", 0)):
        with tracing.traced(slices):
            for j in range(int(traffic["device_calls"])):
                device_searches += driver.call(-2 - j)
    if trace:
        with tracing.traced(slices):
            for j in range(int(traffic["trace_calls"])):
                driver.call(calls + j)
    print(f"bench: seconds of each call in the window: {[round(x, 4) for x in call_s]}",
          file=sys.stderr)
    return Run(searches=searches, window_s=window_s, counters=delta(c0, c1),
               call_s=call_s, b1_layers=driver.b1_layers,
               device_searches=device_searches), t0
