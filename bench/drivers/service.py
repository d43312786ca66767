"""The DSE service under load (``serve.dse.AsyncDSEService``).

The traffic file sets the load:

* ``"loop": "closed"``: ``clients`` clients each hold one request in
  flight and submit the next as soon as the last is answered.  The clients
  are event-driven: an answer's future callback, which the service runs on
  its worker thread, records it and submits that client's next request
  there, so no client thread contends with the service for the
  interpreter.  Latency runs from the submit to the callback.
* ``"loop": "open"``: requests arrive at ``rate_per_s`` on average, with
  exponential gaps drawn from the seed, whatever the service's pace; one
  arrival thread submits each when it is due.  Latency runs from the time
  it was due.

The traffic file's ``engine``, ``service`` and ``request`` objects are
passed unchanged as keywords to ``SearchEngine``, ``AsyncDSEService`` and
each ``SearchRequest``; ``result_cache`` (``ResultCache`` keywords) puts a
result cache in the engine.

The window counts the searches answered inside ``[t0, t0 + seconds]`` and
divides by ``seconds``.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from bench.harness import trace as tracing
from bench.harness import traffic as tr
from bench.harness.check import Answer
from bench.harness.record import Run, delta


class Driver:
    slice_edge = None  # the traced slice's ``edge`` (``trace.traced``): none on one card

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from repro_torch.core.engine import SearchEngine
        from repro_torch.serve.dse import AsyncDSEService

        self.traffic = traffic
        self.search = cfg["search"]
        self.stream = tr.Stream(traffic, list(cfg["workloads"]), seed)
        self.sets = tr.workload_sets(cfg, self.stream.subsets)
        engine_kw = {"direct_seed": bool(self.search["direct_seed"]),
                     **traffic.get("engine", {})}
        if traffic.get("result_cache") is not None:
            from repro_torch.serve.cache import ResultCache

            engine_kw["result_cache"] = ResultCache(
                **traffic["result_cache"], device=device,
                prng=engine_kw.get("prng", "torch"))
        self.engine = SearchEngine(device=device, **engine_kw)
        self.svc = AsyncDSEService(engine=self.engine, **traffic.get("service", {}))
        self.request_kw = dict(traffic.get("request", {}))
        self.closed = traffic.get("loop", "closed") == "closed"
        self.gaps = tr.Arrivals(traffic, seed) if not self.closed else None
        self.lock = threading.Lock()  # the counters below; callbacks run on the worker
        self.idle = threading.Event()
        self.answers: Dict[int, Answer] = {}
        self.t_submit: Dict[int, float] = {}
        self.t_done: Dict[int, float] = {}
        self.outstanding = 0
        self.next_i = 0
        self.run = False
        self.arrivals: Optional[threading.Thread] = None

    def _request(self, i: int):
        from repro_torch.core.engine import SearchRequest

        s = self.stream[i]
        kw = {"pop_size": int(self.search["pop_size"]),
              "generations": int(self.search["generations"]),
              "top_k": int(self.search["top_k"]), **self.request_kw}
        a = Answer(names=s.names, objective=s.objective, area=float(self.search["area_mm2"]),
                   top_k=int(kw["top_k"]), seed=s.seed)
        req = SearchRequest(ws=self.sets[s.names], objective=s.objective,
                            area_constr=a.area, seed=s.seed, **kw)
        return req, a

    def _submit(self, i: int, due: Optional[float] = None) -> None:
        """Submit request ``i``, already counted in ``outstanding``."""
        req, a = self._request(i)
        with self.lock:
            self.answers[i] = a
            self.t_submit[i] = time.perf_counter() if due is None else due
        self.svc.submit(req).add_done_callback(lambda f, i=i: self._answered(i, f))

    def _answered(self, i: int, fut) -> None:
        t = time.perf_counter()
        try:
            res = fut.result()
        except BaseException as e:  # noqa: BLE001 - a failed request is judged, not raised
            res = e
        with self.lock:
            self.t_done[i] = t
            self.answers[i].result = res
            nxt = None
            if self.run and self.closed:
                nxt, self.next_i = self.next_i, self.next_i + 1
            else:
                self.outstanding -= 1
                if not self.run and not self.outstanding:
                    self.idle.set()
        if nxt is not None:
            self._submit(nxt)

    def _arrive(self) -> None:
        """The open loop: submit request i when it is due."""
        due = time.perf_counter()
        k = 0
        while True:
            due += self.gaps[k]
            k += 1
            time.sleep(max(0.0, due - time.perf_counter()))
            with self.lock:
                if not self.run:
                    return
                i, self.next_i = self.next_i, self.next_i + 1
                self.outstanding += 1
            self._submit(i, due)

    def warmup(self) -> None:
        """Whole plans of the cell's signatures, answered before any client
        starts (not counted, not judged)."""
        n = int(self.traffic["warmup_plans"]) * int(self.engine.max_slots)
        futs = [self.svc.submit(self._request(-1 - k)[0]) for k in range(n)]
        for f in futs:
            f.result()

    def start(self) -> None:
        with self.lock:
            self.run = True
        if not self.closed:
            self.arrivals = threading.Thread(target=self._arrive, name="bench-arrivals",
                                             daemon=True)
            self.arrivals.start()
            return
        n = int(self.traffic["clients"])
        with self.lock:
            first, self.next_i = self.next_i, self.next_i + n
            self.outstanding += n
        for i in range(first, first + n):
            self._submit(i)

    @staticmethod
    def pump(until: float) -> None:
        """Let the load run until the host clock reads ``until``."""
        time.sleep(max(0.0, until - time.perf_counter()))

    def stop(self, timeout_s: float = 60.0) -> None:
        """Stop the load and wait (up to ``timeout_s``) for the answers
        still due; an answer that never comes stays ``None``."""
        with self.lock:
            self.run = False
        if self.arrivals is not None:
            self.arrivals.join()
        with self.lock:
            if not self.outstanding:
                self.idle.set()
        self.idle.wait(timeout_s)

    def counters(self) -> Dict[str, float]:
        return {"launches": self.engine.launches,
                "transfer_bytes": self.engine.transfer_bytes}

    def close(self) -> None:
        self.svc.close(timeout=60.0)

    def collected(self) -> List[Answer]:
        with self.lock:
            return list(self.answers.values())

    def completed_between(self, t0: float, t1: float) -> List[int]:
        with self.lock:
            return [i for i, t in self.t_done.items() if t0 <= t <= t1]

    def wait_p95_s(self) -> Optional[float]:
        return self.svc.stats.wait_p(95)


def window(driver, traffic: dict, seconds: float, trace: bool, clock, slices: list) -> tuple:
    """The load ramps up for ``ramp_s``, then the window; the traced slice
    (``trace_s``) follows it.  Returns (Run, the window's start)."""
    driver.start()
    driver.pump(clock() + float(traffic["ramp_s"]))
    c0 = driver.counters()
    t0 = clock()
    driver.pump(t0 + seconds)
    c1 = driver.counters()
    wait = driver.wait_p95_s()
    if trace:
        with tracing.traced(slices, edge=driver.slice_edge):
            driver.pump(clock() + float(traffic["trace_s"]))
    driver.stop()
    done = driver.completed_between(t0, t0 + seconds)
    per_s = np.bincount([int(driver.t_done[i] - t0) for i in done], minlength=int(seconds))
    print(f"bench: searches answered each second of the window: {per_s.tolist()}",
          file=sys.stderr)
    return Run(searches=len(done), window_s=float(seconds), counters=delta(c0, c1),
               latencies_s=[driver.t_done[i] - driver.t_submit[i] for i in done],
               wait_p95_s=wait), t0
