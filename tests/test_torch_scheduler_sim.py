"""The port's scheduler against the JAX package's, on a virtual clock.

The scheduling layer (``plan_batch``'s policies, ``DSEService``'s queue,
deadlines, retry lane, quarantine and statistics) is host Python, so it
is held exactly: the port's twin of ``tests/sim_scheduler.py`` below
(``VirtualClock``, ``StubEngine``, ``FaultyEngine``, ``run_script``)
drives the port's ``DSEService``, the reference harness (imported
read-only) drives the JAX package's, and every scripted scenario must
give both the same completion order, launch log, launch times, wait and
latency samples, deadline misses, failures, retries, quarantines and
abandoned requests, for fifo, priority with aging and edf."""
from __future__ import annotations

import dataclasses
import itertools
import types
from typing import Callable, List, Optional, Sequence, Tuple, Union

import pytest
import sim_scheduler as ref_harness
import torch

from repro.core.engine import PriorityPolicy as RefPriorityPolicy
from repro.serve.dse import RetryPolicy as RefRetryPolicy
from repro_torch.core.engine import (
    BatchPlan,
    EngineFault,
    NonFiniteScoreError,
    PriorityPolicy,
    SearchRequest,
)
from repro_torch.serve.dse import DSEService, RetryPolicy
from repro_torch.workloads.pack import WorkloadSet


# ------------------------------------------------------- the port's harness
class VirtualClock:
    """Monotonic clock a test advances by hand (the service's only time)."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        assert dt >= 0, f"clock can only move forward, got {dt}"
        self.t += float(dt)
        return self.t


_WS = WorkloadSet(names=("sim0",), feats=torch.ones((1, 2, 6)),
                  mask=torch.ones((1, 2), dtype=torch.bool))


def sim_request(seed: int = 0, *, priority: int = 0, deadline_s: Optional[float] = None,
                pop_size: int = 8, generations: int = 2) -> SearchRequest:
    """A request on the dense backend (no table prefill at submit)."""
    return SearchRequest(ws=_WS, seed=seed, backend="dense", pop_size=pop_size,
                         generations=generations, priority=priority,
                         deadline_s=deadline_s)


@dataclasses.dataclass(frozen=True)
class SimResult:
    seed: int
    workload_names: Tuple[str, ...]
    priority: int
    partial: bool = False


@dataclasses.dataclass
class SimLaunch:
    seeds: List[int]
    slots: int
    signature: tuple
    start_s: float
    end_s: float


class StubEngine:
    """``max_slots`` and ``execute(plan)``: each launch advances the clock
    by ``launch_s`` (a constant or a function of the plan)."""

    def __init__(self, clock: VirtualClock, *, max_slots: int = 4,
                 launch_s: Union[float, Callable[[BatchPlan], float]] = 1.0):
        self.clock = clock
        self.max_slots = int(max_slots)
        self.launch_s = launch_s
        self.launches: List[SimLaunch] = []

    def execute(self, plan: BatchPlan, *, dt: Optional[float] = None) -> List[SimResult]:
        t0 = self.clock()
        if dt is None:
            dt = self.launch_s(plan) if callable(self.launch_s) else self.launch_s
        self.clock.advance(dt)
        self.launches.append(SimLaunch(seeds=[r.seed for r in plan.requests],
                                       slots=plan.slots, signature=plan.signature,
                                       start_s=t0, end_s=self.clock()))
        return [SimResult(seed=r.seed, workload_names=r.ws.names, priority=r.priority)
                for r in plan.requests]


@dataclasses.dataclass
class SimFault:
    kind: str
    start_s: float
    seeds: List[int]


class FaultyEngine(StubEngine):
    """Scripted faults, one script entry per launch ("ok", "fail", "nan",
    ("slow", dt)); a launch holding a ``poison_seeds`` request always
    fails the NaN guard; faults carry anytime partials."""

    def __init__(self, clock, *, script: Sequence = (), fail_s: float = 0.1,
                 poison_seeds: Sequence[int] = (), partials: bool = True, **kw):
        super().__init__(clock, **kw)
        self.script = list(script)
        self._cursor = 0
        self.fail_s = float(fail_s)
        self.poison_seeds = set(poison_seeds)
        self.partials = partials
        self.faults: List[SimFault] = []

    def _next_behavior(self):
        if self._cursor < len(self.script):
            b = self.script[self._cursor]
            self._cursor += 1
            return b if isinstance(b, tuple) else (b,)
        return ("ok",)

    def _raise_fault(self, kind: str, plan: BatchPlan):
        t0 = self.clock()
        self.clock.advance(self.fail_s)
        self.faults.append(SimFault(kind=kind, start_s=t0,
                                    seeds=[r.seed for r in plan.requests]))
        partials = None
        if self.partials:
            partials = [SimResult(seed=r.seed, workload_names=r.ws.names,
                                  priority=r.priority, partial=True)
                        for r in plan.requests]
        cls = NonFiniteScoreError if kind == "nan" else EngineFault
        raise cls(f"injected {kind} at t={t0}", partials=partials)

    def execute(self, plan: BatchPlan) -> List[SimResult]:
        if self.poison_seeds & {r.seed for r in plan.requests}:
            self._raise_fault("nan", plan)
        b = self._next_behavior()
        if b[0] in ("fail", "nan"):
            self._raise_fault(b[0], plan)
        if b[0] == "slow":
            return super().execute(plan, dt=float(b[1]))
        return super().execute(plan)


def sim_service(*, policy="fifo", max_slots: int = 4, launch_s=1.0, t0: float = 0.0,
                retry: Optional[RetryPolicy] = None, partial_results: bool = False,
                engine_cls=StubEngine, **engine_kw):
    clock = VirtualClock(t0)
    stub = engine_cls(clock, max_slots=max_slots, launch_s=launch_s, **engine_kw)
    svc = DSEService(engine=stub, policy=policy, clock=clock, retry=retry,
                     partial_results=partial_results, sleep=clock.advance)
    return svc, clock, stub


@dataclasses.dataclass
class SimTrace:
    rids: List[int]
    completions: List[Tuple[int, SimResult, float]]


def run_script(svc, clock, events) -> SimTrace:
    """Events, in order: ("submit", req), ("advance", dt), ("step",),
    ("drain",)."""
    trace = SimTrace(rids=[], completions=[])

    def record(done):
        for rid, res in done:
            trace.completions.append((rid, res, clock()))

    for ev in events:
        if ev[0] == "submit":
            trace.rids.append(svc.submit(ev[1]))
        elif ev[0] == "advance":
            clock.advance(ev[1])
        elif ev[0] == "step":
            record(svc.step())
        elif ev[0] == "drain":
            while svc.pending():
                record(svc.step())
        else:
            raise ValueError(f"unknown sim event {ev!r}")
    return trace


def submit_burst(svc, n, *, priorities=(0,), deadlines_s=(None,), seed0=0):
    pr, dl = itertools.cycle(priorities), itertools.cycle(deadlines_s)
    return [svc.submit(sim_request(seed0 + i, priority=next(pr), deadline_s=next(dl)))
            for i in range(n)]


PORT = types.SimpleNamespace(
    sim_service=sim_service, sim_request=sim_request, run_script=run_script,
    submit_burst=submit_burst, FaultyEngine=FaultyEngine,
    PriorityPolicy=PriorityPolicy, RetryPolicy=RetryPolicy)
REF = types.SimpleNamespace(
    sim_service=ref_harness.sim_service, sim_request=ref_harness.sim_request,
    run_script=ref_harness.run_script, submit_burst=ref_harness.submit_burst,
    FaultyEngine=ref_harness.FaultyEngine,
    PriorityPolicy=RefPriorityPolicy, RetryPolicy=RefRetryPolicy)


# ------------------------------------------------------------- scenarios
def _policy(h, name):
    return h.PriorityPolicy(aging_s=2.0) if name == "priority" else name


def _record(svc, stub, trace=None) -> dict:
    st = svc.stats
    out = dict(
        results=sorted((rid, getattr(r, "seed", None), r.partial)
                       for rid, r in svc.results.items()),
        launch_log=[list(x) for x in svc.launch_log],
        launches=[(l.seeds, l.slots, l.start_s, l.end_s) for l in stub.launches],
        faults=[(f.kind, f.start_s, f.seeds) for f in getattr(stub, "faults", [])],
        waits=list(st.wait_samples), latencies=list(st.latency_samples),
        counts=(st.submitted, st.completed, st.launches, st.busy_s, st.deadline_misses,
                st.failures, st.retries, st.partials, st.abandoned),
        failed=sorted(svc.failed), queued=[rid for rid, _ in svc.queue],
        summary=st.summary(),
    )
    if trace is not None:
        out["completions"] = [(rid, getattr(r, "seed", None), r.partial, t)
                              for rid, r, t in trace.completions]
        out["rids"] = trace.rids
    return out


def scenario_script(h, policy):
    """Interleaved submits, clock advances and steps with mixed priorities
    and deadlines; launch times depend on the plan's size."""
    svc, clock, stub = h.sim_service(policy=_policy(h, policy), max_slots=2,
                                     launch_s=lambda p: 0.5 + 0.25 * len(p.requests))
    req = h.sim_request
    events = [("submit", req(0, priority=3, deadline_s=5.0)), ("submit", req(1)),
              ("submit", req(2, priority=1, deadline_s=1.0)), ("step",),
              ("advance", 0.75), ("submit", req(3, priority=0, deadline_s=2.0)),
              ("submit", req(4, priority=5)), ("step",), ("advance", 3.0),
              ("submit", req(5, priority=2, deadline_s=0.5)),
              ("submit", req(6, priority=0)), ("drain",),
              ("submit", req(7, deadline_s=10.0)), ("step",)]
    trace = h.run_script(svc, clock, events)
    return _record(svc, stub, trace)


def scenario_saturating_stream(h, policy):
    """A low-priority request under a stream of urgent bursts; the stream
    stops after 12 rounds and the queue drains."""
    svc, clock, stub = h.sim_service(policy=_policy(h, policy), max_slots=4, launch_s=1.0)
    svc.submit(h.sim_request(-1, priority=9, deadline_s=30.0))
    for round_ in range(12):
        h.submit_burst(svc, 4, priorities=(0, 1), deadlines_s=(None, 3.0),
                       seed0=100 * round_)
        svc.step()
    svc.drain()
    return _record(svc, stub)


def scenario_quiet_aging(h, policy):
    """Bursts, then only clock advances and steps: the aging re-plan must
    fire without a submit landing."""
    svc, clock, stub = h.sim_service(policy=_policy(h, policy), max_slots=4, launch_s=1.0)
    svc.submit(h.sim_request(-1, priority=9))
    for round_ in range(4):
        h.submit_burst(svc, 4, priorities=(0,), seed0=100 * round_)
        svc.step()
    for _ in range(30):
        if not svc.pending():
            break
        clock.advance(1.0)
        svc.step()
    return _record(svc, stub)


def scenario_fault_drill(h, policy):
    """The JAX package's 256-request fault drill (poisoned seeds, a
    scripted failure, a slow launch, short-deadline stragglers) in
    16-slot chunks; under priority and edf the burst also cycles
    priorities and deadlines."""
    pol = h.RetryPolicy(max_attempts=2, backoff_s=0.25, multiplier=2.0, jitter=0.1)
    svc, clock, stub = h.sim_service(
        policy=_policy(h, policy), max_slots=16, retry=pol, partial_results=True,
        engine_cls=h.FaultyEngine, poison_seeds=[5, 37, 101],
        script=["fail", ("slow", 5.0)])
    mixed = dict(priorities=(0, 2, 1), deadlines_s=(None, 40.0, 90.0))
    h.submit_burst(svc, 252, **(mixed if policy != "fifo" else {}))
    for i in range(4):
        svc.submit(h.sim_request(252 + i, deadline_s=0.5))
    svc.drain()
    return _record(svc, stub)


def scenario_retries_exhausted(h, policy):
    """No partial results: a poisoned request is abandoned after its
    attempts; its chunk-mates finish on their retries."""
    pol = h.RetryPolicy(max_attempts=3, backoff_s=1.0, jitter=0.0)
    svc, clock, stub = h.sim_service(
        policy=_policy(h, policy), max_slots=4, retry=pol, engine_cls=h.FaultyEngine,
        poison_seeds=[2], script=["ok", "nan", "ok", "fail"])
    h.submit_burst(svc, 10, priorities=(1, 0), deadlines_s=(None, 4.0))
    svc.drain()
    return _record(svc, stub)


def scenario_deadline_sweep(h, policy):
    """Queued requests past their deadline resolve with partials; one sits
    in the retry lane when its deadline passes."""
    pol = h.RetryPolicy(max_attempts=3, backoff_s=2.0, jitter=0.0)
    svc, clock, stub = h.sim_service(
        policy=_policy(h, policy), max_slots=2, retry=pol, partial_results=True,
        engine_cls=h.FaultyEngine, script=["fail"], launch_s=1.0)
    svc.submit(h.sim_request(0, deadline_s=1.5))
    svc.submit(h.sim_request(1, deadline_s=0.5))
    svc.submit(h.sim_request(2, priority=2, deadline_s=8.0))
    svc.submit(h.sim_request(3, deadline_s=0.2))
    svc.drain()
    return _record(svc, stub)


SCENARIOS = {f.__name__: f for f in (
    scenario_script, scenario_saturating_stream, scenario_quiet_aging,
    scenario_fault_drill, scenario_retries_exhausted, scenario_deadline_sweep)}


@pytest.mark.parametrize("policy", ["fifo", "priority", "edf"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_scheduler_equals_reference(name, policy):
    ref = SCENARIOS[name](REF, policy)
    port = SCENARIOS[name](PORT, policy)
    assert ref["counts"][1] > 0  # the scenario served requests
    for field in ref:
        assert port[field] == ref[field], field


def test_fault_drill_accounting():
    """The drill's numbers on the port, as the JAX package's test reads them."""
    rec = scenario_fault_drill(PORT, "fifo")
    submitted, completed, launches, _, misses, failures, retries, partials, abandoned = \
        rec["counts"]
    assert (submitted, completed, abandoned) == (256, 256, 0)
    assert failures == 4 * 16 + 3 and retries == 4 * 16 and partials == 7
    assert misses == 4 and launches == 12 + 16 + 3 * 15
    assert sorted(len(f[2]) for f in rec["faults"]) == [1, 1, 1, 16, 16, 16, 16]


def test_sync_step_failure_rolls_back_and_stays_retryable():
    svc, clock, stub = sim_service(max_slots=2, engine_cls=FaultyEngine, script=["fail"])
    rids = submit_burst(svc, 3)
    with pytest.raises(EngineFault):
        svc.step()
    assert [r for r, _ in svc.queue] == rids and len(svc.stats.wait_samples) == 0
    svc.drain()
    assert sorted(svc.results) == rids


def test_async_front_end_on_stub_engines():
    """The worker thread drains a paused-then-resumed service: every future
    resolves with its own request's result, in the policy's launch order."""
    from repro_torch.serve.dse import AsyncDSEService

    clock = VirtualClock()
    stub = StubEngine(clock, max_slots=2)
    with AsyncDSEService(engine=stub, policy="priority", clock=clock, paused=True) as svc:
        futs = [svc.submit(sim_request(i, priority=p)) for i, p in enumerate((3, 0, 2, 1))]
        svc.resume()
        got = [f.result(timeout=60) for f in futs]
        svc.drain(timeout=60)
    assert [g.seed for g in got] == [0, 1, 2, 3]
    assert [l.seeds for l in stub.launches] == [[1, 3], [2, 0]]
