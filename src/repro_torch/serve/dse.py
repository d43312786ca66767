"""DSE as a service: continuous batching of heterogeneous search requests.

Clients ``submit`` ``SearchRequest``s (any mix of workload sets,
objectives, areas, seeds and backends) and the service drains the queue,
slot-packed into as few launches as possible, through a
``core.engine.SearchEngine``:

  * ``submit`` - enqueue a request, returns a request id.  A table-backend
    request gets its cost tables built (memoized on its fingerprint) at
    ingest, so the drain only launches the seeding and the GA.
  * ``step`` - run ONE plan (one launch) of the current queue; requests
    submitted meanwhile join the next plan.
  * ``drain`` - step until the queue is empty; returns {rid: result}.
  * ``stream`` - ``drain`` as a generator of (rid, SearchResult), one plan
    at a time, so callers consume results while later plans run.

Scheduling follows a ``core.engine.SchedulingPolicy``: ``fifo``,
``priority`` (``SearchRequest.priority``, 0 = most urgent, with aging so
nothing starves) or ``edf`` (``SearchRequest.deadline_s`` seconds from
submit, an absolute deadline on the service clock from ingest).  A policy
reorders the queue and the launches, never a result bit.

``AsyncDSEService`` runs the same service on a worker thread: ``submit``
returns a ``concurrent.futures.Future`` at once, and requests submitted
while a launch runs join the next launch.  On CUDA the worker selects the
card of the thread that built the service.

``ServiceStats`` keeps busy time, per-request queue-wait and latency
samples and deadline misses; every clock reading goes through the
injectable ``clock``, so a virtual clock and a stub engine make every
scheduling decision and statistic exact (``tests/test_torch_scheduler_sim.py``).

``mesh=`` (``launch.mesh.make_search_mesh``) runs every launch on a mesh
of ranks, one process per card, each rank making the same calls
(``submit`` ... ``drain``).  The policies read a clock (aging, retry
backoff, deadlines), so only the lead (the mesh's first rank) queues,
plans, looks up and fills the result cache and writes checkpoints; before
each launch it sends every rank the plan (``core.distributed.
broadcast_object``), and the other ranks run what they receive
(``_follow``): their part of the launch, whose gathered results every rank
holds.  A follower's ``results`` gets every request's result, those the
lead resolved without a launch (cache hits, partials) included, and a
request the lead gave up on fails on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import (
    Callable,
    Deque,
    Dict,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

import torch

from repro_torch import spans
from repro_torch.core import distributed as mdist
from repro_torch.core.engine import (
    BatchPlan,
    EngineFault,
    RequestMeta,
    SearchEngine,
    SearchRequest,
    SearchResult,
    empty_partial_result,
    get_policy,
    plan_batch,
)
from repro_torch.core.objectives import OBJECTIVES
from repro_torch.workloads.pack import WorkloadSet


def _percentile(samples: Sequence[float], q: float) -> Optional[float]:
    # None, not NaN, on an empty window: NaN is invalid JSON and poisons
    # any bench row serializing a fresh service's summary()
    if not samples:
        return None
    return float(np.percentile(np.asarray(samples, np.float64), q))


# Per-request samples kept for percentile telemetry: a bounded recent
# window (deque maxlen), so a long-lived service's memory stays O(1) and
# the percentiles describe recent traffic rather than all-time history.
SAMPLE_WINDOW = 4096
LAUNCH_LOG_WINDOW = 4096
# seconds between the idle async lead's messages to its followers on a mesh
HEARTBEAT_S = 10.0


@dataclasses.dataclass
class ServiceStats:
    """Running drain telemetry (the ``--serve`` summary line reads these).

    ``busy_s`` is wall time inside ``engine.execute`` only —
    ``requests_per_s`` is therefore a BUSY throughput, not an end-to-end
    one.  ``wait_samples`` (dispatch - submit) and ``latency_samples``
    (complete - submit) are per-request, on the service clock, bounded
    to the most recent ``SAMPLE_WINDOW`` completions, so
    ``wait_p``/``latency_p`` percentiles describe what clients recently
    experienced; ``deadline_misses`` counts requests completed after
    their absolute deadline (any policy — EDF just minimizes it).
    After an engine failure ``submitted`` stays ahead of ``completed``:
    failed requests are never counted as served.

    Fault telemetry: ``failures`` counts failed request-attempts (every
    rid in a failed launch, once per failed attempt), ``retries`` the
    re-queues a ``RetryPolicy`` scheduled, ``partials`` the requests
    resolved with an anytime ``partial=True`` result (quarantine or
    deadline sweep — these DO count as completed), and ``abandoned`` the
    requests dropped for good with no result (no retry policy / retries
    exhausted without partial results).

    ``cache_hits`` counts requests resolved AT SUBMIT from the result
    cache (zero launches; they count as completed with 0 wait/latency);
    ``cache_misses`` the submits that had a cache and missed it.
    ``cache_hit_rate()`` is hits over looked-up submits (0.0 before any
    lookup) — the service-level view of the cache's own
    ``CacheStats.hit_rate()``, which additionally distinguishes the
    memory and disk tiers.

    Launch-overlap telemetry (the pipelined drain's effectiveness):
    ``dispatch_gap_samples`` records, per launch, how long the dispatched
    device work waited before its harvest started (harvest start -
    dispatch end; always 0 on the sequential path, where execute syncs
    inline), and ``device_idle_s`` accumulates an ESTIMATE of wall time
    with nothing in flight between one harvest finishing and the next
    dispatch starting — the overlap win shows up as near-zero idle while
    the gap stays small.  It is a host estimate of the time with no
    launch in flight, not the device's idle time: the card idles also
    while a launch is in flight and the host enqueues its work, so the
    ``--serve`` summary prints it as "no launch in flight (host
    estimate)", and only a device trace measures the card's idle share.

    Percentiles over empty sample windows are ``None`` (a fresh service
    has no telemetry) — never NaN, which is invalid JSON and poisons
    serialized bench rows."""

    submitted: int = 0
    completed: int = 0
    launches: int = 0
    busy_s: float = 0.0  # wall time spent inside execute()
    deadline_misses: int = 0
    failures: int = 0
    retries: int = 0
    partials: int = 0
    abandoned: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    wait_samples: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=SAMPLE_WINDOW))
    latency_samples: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=SAMPLE_WINDOW))
    dispatch_gap_samples: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=SAMPLE_WINDOW))
    device_idle_s: float = 0.0

    def requests_per_s(self) -> float:
        return self.completed / self.busy_s if self.busy_s > 0 else 0.0

    def wait_p(self, q: float) -> Optional[float]:
        """Queue-wait percentile in seconds (q in [0, 100]); ``None``
        when the sample window is empty."""
        return _percentile(self.wait_samples, q)

    def latency_p(self, q: float) -> Optional[float]:
        """End-to-end (submit -> complete) latency percentile in
        seconds; ``None`` when the sample window is empty."""
        return _percentile(self.latency_samples, q)

    def cache_hit_rate(self) -> float:
        """Fraction of cache-looked-up submits resolved at submit (0.0
        before any lookup — a cacheless or cold service reports 0)."""
        total = self.cache_hits + self.cache_misses
        return self.cache_hits / total if total else 0.0

    def dispatch_gap_p(self, q: float) -> Optional[float]:
        """Dispatch-end -> harvest-start gap percentile in seconds;
        ``None`` before any launch was harvested."""
        return _percentile(self.dispatch_gap_samples, q)

    def summary(self) -> Dict[str, Optional[float]]:
        return {
            "requests_per_s": self.requests_per_s(),
            "wait_p50_s": self.wait_p(50), "wait_p99_s": self.wait_p(99),
            "latency_p50_s": self.latency_p(50),
            "latency_p99_s": self.latency_p(99),
            "deadline_misses": self.deadline_misses,
            "failures": self.failures,
            "retries": self.retries,
            "partials": self.partials,
            "abandoned": self.abandoned,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_rate": self.cache_hit_rate(),
            "dispatch_gap_p50_s": self.dispatch_gap_p(50),
            "device_idle_s": self.device_idle_s,
        }


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter on the SERVICE clock.

    ``max_attempts`` is the TOTAL launch attempts a request gets (so
    ``max_attempts=3`` means the original try plus 2 retries); after the
    n-th failure the retry is scheduled ``delay_s(n, rid)`` seconds out.
    Jitter is a pure hash of (rid, attempt) — no wall-clock entropy — so
    a scripted fault drill replays to the exact same schedule."""

    max_attempts: int = 3
    backoff_s: float = 0.5
    multiplier: float = 2.0
    max_backoff_s: float = 30.0
    jitter: float = 0.1  # +/- fraction of the base delay

    def delay_s(self, attempt: int, rid: int = 0) -> float:
        base = min(self.backoff_s * self.multiplier ** (max(attempt, 1) - 1),
                   self.max_backoff_s)
        if self.jitter <= 0 or base <= 0:
            return base
        u = ((rid * 2654435761 + attempt * 40503) % 4096) / 4096.0
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))


@dataclasses.dataclass
class _Retry:
    """One queued retry: dispatched alone (re-plan isolation) once the
    service clock passes ``not_before``."""

    not_before: float
    rid: int
    req: SearchRequest
    attempts: int  # failed attempts so far


class DSEService:
    """Continuous-batching front end over a ``SearchEngine``.

    ``policy`` is a name (fifo / priority / edf) or a
    ``SchedulingPolicy`` instance; ``clock`` (default ``time.monotonic``)
    is the ONLY time source — submit stamps, waits, deadlines and busy
    time all read it, so a virtual clock makes every scheduling decision
    and every stat deterministic (tests/test_torch_scheduler_sim.py).

    Fault tolerance (both OFF by default — behaviour is then exactly the
    pre-retry service: sync ``step()`` rolls back and re-raises, the
    async worker fails futures):

      * ``retry`` (a ``RetryPolicy``): a failed launch re-queues each of
        its requests into an isolated retry lane — every retry is
        re-planned ALONE, so one poisoned request stops failing its
        chunk-mates — with exponential backoff on the service clock.  A
        request that exhausts ``max_attempts`` is quarantined: resolved
        with its best-so-far partial result (``partial_results=True``) or
        abandoned into ``self.failed``.
      * ``partial_results=True``: graceful degradation — a quarantined
        request, and any queued request observed past its deadline,
        resolves with its checkpointed/anytime best (``partial=True``,
        ``EngineFault.partials`` or an empty invalid result) instead of
        nothing.
      * ``sleep`` (default ``time.sleep``): how ``drain``/``stream`` wait
        out retry backoff; the sim passes the virtual clock's ``advance``.

    Result caching (``result_cache``, a ``serve.cache.ResultCache``): a
    submit whose ``request_key`` is cached resolves IMMEDIATELY — the
    request never queues, never launches, and counts as completed with 0
    wait/latency (``stats.cache_hits``).  Misses populate the cache at
    ``_complete`` (full results only; partials never enter), so
    re-submitting an identical mix drains with zero new GA launches and
    bit-identical results.  When the engine was built by this service
    the cache is shared with it; an explicitly passed engine keeps its
    own ``result_cache`` (and the service adopts it if not given one).

    ``pipelined=True`` drains multi-plan queues double-buffered: each
    ``stream``/``drain`` iteration DISPATCHES plan i+1 (enqueued, the
    device starts computing) before HARVESTING plan i (the host-blocking
    finalize), so host packing of one launch overlaps device compute of
    the next.  Results are bit-identical to the sequential drain — only
    the launch interleaving changes — but results carry ``ga=None``
    (transfer-thin; see ``SearchEngine``), so a shared result cache
    stores cache-hits from sequential runs only.  The knob is inherited
    from an explicitly passed engine's own ``pipelined`` flag when left
    ``None``, and silently falls back to the sequential drain on engines
    without the dispatch/harvest split (stubs, fault wrappers).

    ``prng`` picks the random streams of the engine the service builds
    (``SearchEngine(prng=...)``: ``"torch"``, the default, or
    ``"threefry"``, which replays the JAX package's service from each
    request's seed or key); a passed engine keeps its own, and a ``prng``
    that differs from it raises.

    ``mesh`` runs the service on a mesh of ranks (the module docstring):
    the engine it builds gets the mesh, and a passed engine must run on
    it.  Every rank makes the same calls in the same order.
    """

    def __init__(
        self,
        *,
        engine: Optional[SearchEngine] = None,
        device="cuda",
        max_slots: int = 64,
        policy="fifo",
        clock=time.monotonic,
        retry: Optional[RetryPolicy] = None,
        partial_results: bool = False,
        sleep=None,
        result_cache=None,
        pipelined: Optional[bool] = None,
        mesh=None,
        prng: Optional[str] = None,
    ):
        own = getattr(engine, "prng", None)
        if prng is not None and own is not None and own != prng:
            raise ValueError(f"engine draws prng={own!r}, the service asks for {prng!r}")
        if engine is not None and mesh is not None and getattr(engine, "mesh", None) is not mesh:
            raise ValueError("the engine passed runs on another mesh than the service's")
        self.engine = engine or SearchEngine(device=device, max_slots=max_slots,
                                             result_cache=result_cache,
                                             pipelined=bool(pipelined),
                                             prng=prng or "torch", mesh=mesh)
        # on a mesh: the lead plans and sends, the other ranks follow
        self.mesh = getattr(self.engine, "mesh", None)
        self._follower = not mdist.is_lead(self.mesh)
        self._seq = 0  # launches announced to the followers
        self._depth = 0  # nesting of the lead's driving calls (step, stream)
        # the lead's resolutions without a launch (cache hits, partials,
        # abandoned requests), sent with its next message
        self._unsent: Dict[int, object] = {}
        self._unsent_lock = threading.Lock()
        if pipelined is None:
            self.pipelined = bool(getattr(self.engine, "pipelined", False))
        else:
            self.pipelined = bool(pipelined)
        # stub/wrapper engines (sim FakeEngine, fault injectors) have no
        # dispatch/harvest split — they drain sequentially regardless
        self._can_pipeline = (hasattr(self.engine, "dispatch")
                              and hasattr(self.engine, "harvest"))
        # overlap telemetry: launches currently dispatched-not-harvested,
        # and when the device last went quiet (None = never launched)
        self._inflight = 0
        self._last_harvest_end: Optional[float] = None
        self.result_cache = (
            result_cache if result_cache is not None
            else getattr(self.engine, "result_cache", None)
        )
        self.policy = get_policy(policy)
        self.clock = clock
        # wall-clock aging horizon (PriorityPolicy only): a cached plan
        # list is ordered by priorities computed at build time, so once
        # ``aging_s`` passes, some queued request has earned a promotion
        # the cache cannot reflect — ``_dispatch`` invalidates and
        # re-plans (on the warm slot hints).
        # Without this, aging only applied when a submit happened to
        # land, and a busy drain could starve an aged request forever.
        self._aging_s: Optional[float] = getattr(self.policy, "aging_s", None)
        self._plans_built_s: float = 0.0
        self.retry = retry
        self.partial_results = bool(partial_results)
        self._sleep = time.sleep if sleep is None else sleep
        # retry lane + per-rid fault bookkeeping
        self._retry_lane: List[_Retry] = []
        self._attempts: Dict[int, int] = {}
        self._partials: Dict[int, SearchResult] = {}  # best-so-far per rid
        self.failed: Dict[int, BaseException] = {}  # quarantined, no result
        self.queue: List[Tuple[int, SearchRequest]] = []
        self.results: Dict[int, SearchResult] = {}
        self.stats = ServiceStats()
        self.launch_log: List[List[int]] = []  # rids per launch, in order
        self._next_rid = 0
        # per-rid queue facts: submit stamp + absolute deadline (clock() +
        # SearchRequest.deadline_s at ingest) — what the policy keys on
        self._submit_s: Dict[int, float] = {}
        self._deadline_s: Dict[int, Optional[float]] = {}
        # signature -> slot size of the last plan that used it: re-plans
        # (mid-drain submits) round small residues UP to it, so the chunk
        # shapes (and plan_key) stay those of the JAX package's service
        self._slot_hints: Dict[tuple, int] = {}
        # plans for the current queue snapshot; invalidated on submit so
        # a quiescent drain keeps plan_batch's chunking instead of
        # re-planning the shrunken residue each step
        self._plans_cache: Optional[List[BatchPlan]] = None
        self._snapshot: List[Tuple[int, SearchRequest]] = []
        # mid-search best-so-far stream subscribers, per rid
        self._progress_cbs: Dict[int, Callable] = {}

    # ------------------------------------------------------------- admission
    def submit(self, req: SearchRequest, *, on_progress=None) -> int:
        """Enqueue one request; returns its rid.  Validates the request's
        signature eagerly (bad objectives/backends fail at submit, not
        mid-drain) and pre-builds table-backend cost tables so drains only
        launch the seeding and the GA.

        A threefry ``key`` on an engine on the torch streams fails here.
        A result-cache hit resolves the rid right here: the result is in
        ``self.results`` before ``submit`` returns, nothing queues, and
        no launch ever runs for it.

        ``on_progress(rid, partial)`` subscribes to the request's
        mid-search best-so-far stream: called after every guarded GA
        segment with a monotone ``partial=True`` snapshot (requires an
        engine with ``segment_gens``; single-shot engines have no
        mid-search boundaries and never call it).  Callbacks run on the
        draining thread, between segment launches."""
        with spans.span("serve.submit", key=self._next_rid):
            req.signature()
            check = getattr(self.engine, "check_request", None)
            if check is not None:
                check(req)
            if self._follower:  # the lead queues it; this rank numbers it alike
                rid = self._next_rid
                self._next_rid += 1
                return rid
            if self.result_cache is not None:
                hit = self.result_cache.get(req)
                if hit is not None:
                    rid = self._next_rid
                    self._next_rid += 1
                    self.results[rid] = hit
                    self._forward(rid, hit)
                    self.stats.submitted += 1
                    self.stats.completed += 1
                    self.stats.cache_hits += 1
                    self.stats.wait_samples.append(0.0)
                    self.stats.latency_samples.append(0.0)
                    return rid
                self.stats.cache_misses += 1
            if req.backend == "table":
                req.ws.tables(req.tech)  # fingerprint-memoized ingest prefill
            now = self.clock()
            rid = self._next_rid
            self._next_rid += 1
            self.queue.append((rid, req))
            self._submit_s[rid] = now
            self._deadline_s[rid] = (
                None if req.deadline_s is None else now + float(req.deadline_s)
            )
            if on_progress is not None:
                self._progress_cbs[rid] = on_progress
            self.stats.submitted += 1
            self._plans_cache = None  # next step re-packs the grown queue
            return rid

    def submit_all(self, reqs: Sequence[SearchRequest]) -> List[int]:
        return [self.submit(r) for r in reqs]

    def pending(self) -> int:
        return len(self.queue) + len(self._retry_lane)

    # ------------------------------------------------------------- the mesh
    def _forward(self, rid: int, res) -> None:
        """Queue a resolution without a launch (a result, or the exception
        an abandoned request failed with) for the followers."""
        if self.mesh is not None:
            if isinstance(res, BaseException):
                res = RuntimeError(f"the lead abandoned rid {rid}: {res!r}")
            with self._unsent_lock:
                self._unsent[rid] = res

    def _send(self, op: str, *payload) -> None:
        """The lead's message to every rank of the mesh: what to run next,
        and the resolutions made since the last message."""
        with self._unsent_lock:
            unsent, self._unsent = self._unsent, {}
        mdist.broadcast_object(self.mesh, (op, payload, unsent))

    @contextlib.contextmanager
    def _session(self):
        """The lead's outermost driving call (``step``, ``stream``) ends
        with a ``stop`` that ends the followers' matching call, carrying
        the lead's failure if it raised."""
        outer = self.mesh is not None and self._depth == 0
        self._depth += 1
        failure = None
        try:
            yield
        except BaseException as e:
            failure = repr(e)
            raise
        finally:
            self._depth -= 1
            if outer:
                self._send("stop", failure)

    def _launch(self, plan: BatchPlan, rids: List[int], kw: Dict):
        """``engine.dispatch``, announced to the followers on a mesh."""
        if self.mesh is None:
            return self.engine.dispatch(plan, **kw)
        self._seq += 1
        self._send("dispatch", self._seq, plan, list(rids))
        pend = self.engine.dispatch(plan, **kw)
        pend.seq = self._seq
        return pend

    def _harvest(self, pend) -> List[SearchResult]:
        """``engine.harvest``, announced to the followers on a mesh."""
        if self.mesh is not None:
            self._send("harvest", pend.seq)
        return self.engine.harvest(pend)

    def _execute(self, plan: BatchPlan, rids: List[int], kw: Dict) -> List[SearchResult]:
        if self.mesh is None:
            return self.engine.execute(plan, **kw)
        return self._harvest(self._launch(plan, rids, kw))

    def _follow(self) -> Iterator[Tuple[int, object]]:
        """A follower's side of the lead's driving call: run each launch
        the lead announces (its part, and the gathers) until the lead's
        ``stop``; yields (rid, result) as results land, and (rid,
        exception) for a request the lead abandoned.  A launch that fails
        here failed on the lead too, which decides what follows."""
        inflight: Dict[int, Optional[Tuple[object, List[int]]]] = {}
        while True:
            op, payload, resolved = mdist.broadcast_object(self.mesh)
            for rid, res in resolved.items():
                if isinstance(res, BaseException):
                    self.failed[rid] = res
                else:
                    self.results[rid] = res
                yield rid, res
            if op == "stop":
                if payload[0] is not None:
                    raise RuntimeError(f"the lead rank's drain failed: {payload[0]}")
                return
            if op == "dispatch":
                seq, plan, rids = payload
                try:
                    inflight[seq] = (self.engine.dispatch(plan), rids)
                except Exception:  # noqa: BLE001 - the lead's launch failed alike
                    inflight[seq] = None
            elif op == "harvest":
                entry = inflight.pop(payload[0])
                if entry is None:
                    continue
                try:
                    results = self.engine.harvest(entry[0])
                except Exception:  # noqa: BLE001 - the lead's harvest failed alike
                    continue
                for rid, res in zip(entry[1], results):
                    self.results[rid] = res
                    yield rid, res

    # --------------------------------------------------------------- serving
    def _plans(self) -> List[BatchPlan]:
        """Plans over the current queue snapshot, cached across steps: a
        drain executes the ONE padded chunking plan_batch produced (plan
        indices refer to the snapshot), and only a new submission forces
        a re-pack — where the slot hints keep re-planned residues on the
        chunk sizes used before."""
        if self._plans_cache is None:
            now = self.clock()
            self._plans_built_s = now
            self._snapshot = list(self.queue)
            meta = [
                RequestMeta(
                    seq=rid,
                    priority=int(r.priority),
                    wait_s=now - self._submit_s[rid],
                    deadline_s=self._deadline_s[rid],
                )
                for rid, r in self._snapshot
            ]
            self._plans_cache = plan_batch(
                [r for _, r in self._snapshot],
                max_slots=self.engine.max_slots,
                policy=self.policy,
                meta=meta,
                slot_hints=self._slot_hints,
            )
            for p in self._plans_cache:
                self._slot_hints[p.signature] = p.slots
        return self._plans_cache

    @spans.span("serve.schedule")
    def _dispatch(self) -> Optional[Tuple[BatchPlan, List[int], float]]:
        """Pick the policy's next plan and remove its requests from the
        queue — the admission point: everything still queued after this
        (including anything submitted while the launch runs) is free to
        re-plan.  Returns (plan, rids, dispatch stamp); pure queue
        surgery, no device work, so the async front end holds its lock
        only across this and ``_complete``.

        Due retries dispatch FIRST, one per step, each re-planned alone
        (quarantine isolation: a poisoned request can only fail its own
        launch from here on) on the warm slot hints."""
        now = self.clock()
        due = [e for e in self._retry_lane if e.not_before <= now]
        if due:
            e = min(due, key=lambda e: (e.not_before, e.rid))
            self._retry_lane.remove(e)
            plan = plan_batch([e.req], max_slots=self.engine.max_slots,
                              slot_hints=self._slot_hints)[0]
            self.stats.wait_samples.append(now - self._submit_s[e.rid])
            return plan, [e.rid], now
        if not self.queue:
            return None
        if (self._plans_cache is not None and self._aging_s is not None
                and now - self._plans_built_s >= self._aging_s):
            # aging re-plan: the cached plan order is >= aging_s old, so
            # wait-time promotions have accrued that it cannot reflect —
            # rebuild with fresh wait_s (see __init__; starvation-freedom
            # is pinned on the virtual clock in tests/test_torch_scheduler_sim.py)
            self._plans_cache = None
        plans = self._plans()
        plan = plans.pop(0)
        if not plans:
            self._plans_cache = None
        rids = [self._snapshot[qi][0] for qi in plan.indices]
        taken = set(rids)
        self.queue = [q for q in self.queue if q[0] not in taken]
        now = self.clock()
        for rid in rids:
            self.stats.wait_samples.append(now - self._submit_s[rid])
        return plan, rids, now

    def _drop_wait_samples(self, n: int) -> None:
        for _ in range(min(n, len(self.stats.wait_samples))):
            self.stats.wait_samples.pop()  # newest = this dispatch's

    def _rollback(self, plan: BatchPlan, rids: List[int]) -> None:
        """Undo a dispatch whose launch failed (sync path): the requests
        return to the queue with their original submit stamps intact —
        ``step()`` stays retryable — and the dispatch's wait samples are
        dropped (the requests were never served)."""
        self._drop_wait_samples(len(rids))
        self.queue = list(zip(rids, plan.requests)) + self.queue
        self._plans_cache = None  # the popped plan list is now stale

    def _abandon(self, rids: List[int]) -> None:
        """Drop failed in-flight requests for good (async path: their
        futures carry the exception): purge per-rid bookkeeping so a
        long-lived worker that survives engine failures leaks nothing
        and keeps wait/latency sample counts consistent.  Counted in
        ``stats.abandoned`` — never silently dropped."""
        self._drop_wait_samples(len(rids))
        for rid in rids:
            self._forward(rid, RuntimeError("launch failed"))
            self._submit_s.pop(rid, None)
            self._deadline_s.pop(rid, None)
            self._attempts.pop(rid, None)
            self._partials.pop(rid, None)
            self._progress_cbs.pop(rid, None)
        self.stats.abandoned += len(rids)

    # -------------------------------------------------- fault tolerance
    def _next_retry_due(self) -> Optional[float]:
        if not self._retry_lane:
            return None
        return min(e.not_before for e in self._retry_lane)

    def _resolve_partial(self, rid: int, req: SearchRequest,
                         now: float) -> Tuple[int, SearchResult]:
        """Resolve a rid with its best-so-far anytime result (stored
        ``EngineFault`` partial, else an empty invalid one).  Partials
        count as completions — the rid has a result — and as a deadline
        miss when applicable."""
        res = self._partials.pop(rid, None)
        if res is None:
            res = empty_partial_result(req)
        elif getattr(res, "partial", True) is False:
            res = dataclasses.replace(res, partial=True)
        self.results[rid] = res
        self._forward(rid, res)
        self.stats.partials += 1
        self.stats.completed += 1
        waited = now - self._submit_s.pop(rid)
        self.stats.wait_samples.append(waited)
        self.stats.latency_samples.append(waited)
        dl = self._deadline_s.pop(rid, None)
        if dl is not None and now > dl:
            self.stats.deadline_misses += 1
        self._attempts.pop(rid, None)
        self._progress_cbs.pop(rid, None)
        return rid, res

    def _sweep_deadlines(self) -> List[Tuple[int, SearchResult]]:
        """Graceful degradation (``partial_results=True`` only): any
        QUEUED request — main queue or retry lane — observed past its
        absolute deadline resolves immediately with its best-so-far
        partial instead of burning a launch it already missed."""
        now = self.clock()
        out: List[Tuple[int, SearchResult]] = []

        def expired(rid: int) -> bool:
            dl = self._deadline_s.get(rid)
            return dl is not None and now > dl

        dead = [(rid, req) for rid, req in self.queue if expired(rid)]
        if dead:
            gone = {rid for rid, _ in dead}
            self.queue = [q for q in self.queue if q[0] not in gone]
            self._plans_cache = None
        dead += [(e.rid, e.req) for e in self._retry_lane if expired(e.rid)]
        self._retry_lane = [e for e in self._retry_lane if not expired(e.rid)]
        for rid, req in dead:
            out.append(self._resolve_partial(rid, req, now))
        return out

    def _handle_failure(
        self, plan: BatchPlan, rids: List[int], exc: BaseException
    ) -> Tuple[List[Tuple[int, SearchResult]], List[int]]:
        """The retry-policy failure path for one failed launch: harvest
        any anytime partials the fault carried, then per request either
        schedule an isolated backed-off retry, resolve with the partial
        best (quarantine under ``partial_results``), or abandon into
        ``self.failed``.  Returns (partial resolutions, abandoned rids)
        — the async worker fails the latter's futures."""
        assert self.retry is not None
        self._drop_wait_samples(len(rids))
        if isinstance(exc, EngineFault) and exc.partials:
            for rid, p in zip(rids, exc.partials):
                if p is not None:
                    self._partials[rid] = p
        now = self.clock()
        resolutions: List[Tuple[int, SearchResult]] = []
        failed: List[int] = []
        for rid, req in zip(rids, plan.requests):
            a = self._attempts.get(rid, 0) + 1
            self._attempts[rid] = a
            self.stats.failures += 1
            if a < self.retry.max_attempts:
                self._retry_lane.append(_Retry(
                    not_before=now + self.retry.delay_s(a, rid),
                    rid=rid, req=req, attempts=a,
                ))
                self.stats.retries += 1
            elif self.partial_results:
                resolutions.append(self._resolve_partial(rid, req, now))
            else:
                self.failed[rid] = exc
                self._forward(rid, exc)
                failed.append(rid)
        for rid in failed:  # wait samples already dropped above
            self._submit_s.pop(rid, None)
            self._deadline_s.pop(rid, None)
            self._attempts.pop(rid, None)
            self._partials.pop(rid, None)
            self._progress_cbs.pop(rid, None)
        self.stats.abandoned += len(failed)
        return resolutions, failed

    def _complete(
        self, rids: List[int], results: Sequence[SearchResult], busy_s: float,
        reqs: Optional[Sequence[SearchRequest]] = None,
    ) -> List[Tuple[int, SearchResult]]:
        """Record one finished launch: results, latency/deadline stats,
        result-cache population (``reqs`` aligns with ``rids``; full
        results only — ``ResultCache.put`` refuses partials itself)."""
        now = self.clock()
        self.stats.busy_s += busy_s
        self.stats.launches += 1
        self.launch_log.append(list(rids))
        if len(self.launch_log) > LAUNCH_LOG_WINDOW:
            del self.launch_log[: len(self.launch_log) - LAUNCH_LOG_WINDOW]
        done: List[Tuple[int, SearchResult]] = []
        for i, (rid, res) in enumerate(zip(rids, results)):
            self.results[rid] = res
            if self.result_cache is not None and reqs is not None:
                self.result_cache.put(reqs[i], res)
            self.stats.latency_samples.append(now - self._submit_s[rid])
            dl = self._deadline_s.pop(rid, None)
            self._submit_s.pop(rid, None)
            self._attempts.pop(rid, None)
            self._partials.pop(rid, None)
            self._progress_cbs.pop(rid, None)
            if dl is not None and now > dl:
                self.stats.deadline_misses += 1
            done.append((rid, res))
        self.stats.completed += len(done)
        return done

    def _progress_kw(self, rids: List[int]) -> Dict[str, Callable]:
        """The ``on_progress`` kwarg for one launch, mapping the engine's
        plan-local index to the subscribed rid — or ``{}`` when no rid in
        the plan subscribed, so engines without the parameter (stubs,
        fault-injection wrappers) are never handed an unknown kwarg."""
        cbs = [self._progress_cbs.get(rid) for rid in rids]
        if not any(cb is not None for cb in cbs):
            return {}

        def bridge(i: int, snap: SearchResult, _cbs=cbs, _rids=rids):
            cb = _cbs[i]
            if cb is not None:
                cb(_rids[i], snap)

        return {"on_progress": bridge}

    def step(self) -> List[Tuple[int, SearchResult]]:
        """Run ONE slot-packed launch (the policy's most urgent plan of
        the current queue); returns that plan's (rid, result) pairs —
        plus, under ``partial_results``, any deadline-swept partial
        resolutions.  Requests submitted while a step runs simply join
        the next plan.  With a ``retry`` policy an engine failure is
        absorbed (retry lane / quarantine) instead of raised.  A follower
        on a mesh runs its part of the lead's step."""
        if self._follower:
            return [(rid, r) for rid, r in self._follow()
                    if not isinstance(r, BaseException)]
        with self._session():
            return self._step()

    def _step(self) -> List[Tuple[int, SearchResult]]:
        swept = self._sweep_deadlines() if self.partial_results else []
        d = self._dispatch()
        if d is None:
            return swept
        plan, rids, t0 = d
        if self._last_harvest_end is not None:
            self.stats.device_idle_s += max(0.0, t0 - self._last_harvest_end)
        try:
            results = self._execute(plan, rids, self._progress_kw(rids))
        except Exception as e:
            if self.retry is None:
                self._rollback(plan, rids)  # step() stays retryable
                raise
            resolutions, _ = self._handle_failure(plan, rids, e)
            return swept + resolutions
        except BaseException:
            # KeyboardInterrupt & co: always roll back and surface —
            # the kill half of the kill/resume contract
            self._rollback(plan, rids)
            raise
        with spans.span("serve.complete"):
            te = self.clock()
            # sequential execute harvests inline: the gap is 0 by definition
            self.stats.dispatch_gap_samples.append(0.0)
            self._last_harvest_end = te
            return swept + self._complete(rids, results, te - t0, plan.requests)

    def _wait_for_retries(self) -> None:
        """Nothing dispatchable but retries are backed off: sleep the
        service clock forward to the next ``not_before``."""
        nb = self._next_retry_due()
        if nb is not None:
            dt = nb - self.clock()
            if dt > 0:
                self._sleep(dt)

    def _harvest_one(
        self, entry: Tuple[BatchPlan, List[int], float, object, float]
    ) -> List[Tuple[int, SearchResult]]:
        """Harvest one in-flight launch ``(plan, rids, t0, pending, td)``:
        blocks on the device sync, records the dispatch->harvest gap, and
        completes (or fails, mirroring ``step()``'s fault handling) the
        launch's requests.  ``busy_s`` gets the HOST time only (dispatch +
        harvest walls) — the overlapped in-flight window is exactly what
        the pipelined drain does not spend blocked."""
        plan, rids, t0, pend, td = entry
        th = self.clock()
        try:
            results = self._harvest(pend)
        except Exception as e:
            self._inflight -= 1
            if self._inflight == 0:
                self._last_harvest_end = self.clock()
            if self.retry is None:
                self._rollback(plan, rids)
                raise
            resolutions, _ = self._handle_failure(plan, rids, e)
            return resolutions
        except BaseException:
            self._inflight -= 1
            self._rollback(plan, rids)
            raise
        with spans.span("serve.complete"):
            te = self.clock()
            self.stats.dispatch_gap_samples.append(max(0.0, th - td))
            self._inflight -= 1
            if self._inflight == 0:
                self._last_harvest_end = te
            return self._complete(rids, results, (td - t0) + (te - th),
                                  plan.requests)

    def _stream_pipelined(self) -> Iterator[Tuple[int, SearchResult]]:
        """Double-buffered drain: dispatch plan i+1, THEN harvest plan i,
        so the host-side finalize of one launch overlaps device compute
        of the next.  Seeding plan i+1 reads the device once a round, on
        the engine's seeding stream, so on CUDA that dispatch need not wait
        for plan i's GA still queued (the engine class says why); the
        overlap is plan i's GA and finalize against plan i+1's seeding and
        GA.  At most one launch is in flight beyond the one
        being harvested; any exception rolls the in-flight launch's
        requests back into the queue before propagating."""
        prev = None  # (plan, rids, t0, pending, td) still in flight
        try:
            while True:
                swept = (self._sweep_deadlines()
                         if self.partial_results else [])
                yield from swept
                d = self._dispatch()
                if d is None:
                    if prev is not None:
                        to_harvest, prev = prev, None
                        yield from self._harvest_one(to_harvest)
                        continue
                    if not self.pending():
                        return
                    self._wait_for_retries()
                    continue
                plan, rids, t0 = d
                if self._inflight == 0 and self._last_harvest_end is not None:
                    self.stats.device_idle_s += max(
                        0.0, t0 - self._last_harvest_end)
                try:
                    pend = self._launch(plan, rids, self._progress_kw(rids))
                except Exception as e:
                    # a failed dispatch resolves like a failed launch; the
                    # in-flight prev is untouched and harvests next round
                    if self.retry is None:
                        self._rollback(plan, rids)
                        raise
                    resolutions, _ = self._handle_failure(plan, rids, e)
                    yield from resolutions
                    continue
                except BaseException:
                    self._rollback(plan, rids)
                    raise
                td = self.clock()
                self._inflight += 1
                cur = (plan, rids, t0, pend, td)
                if prev is not None:
                    # swap BEFORE harvesting: if the harvest raises, the
                    # outer handler rolls back cur (prev already rolled
                    # back inside _harvest_one), never double-rolls
                    to_harvest, prev = prev, cur
                    yield from self._harvest_one(to_harvest)
                else:
                    prev = cur
        except BaseException:
            if prev is not None:
                self._inflight -= 1
                self._rollback(prev[0], prev[1])
            raise

    def stream(self) -> Iterator[Tuple[int, SearchResult]]:
        """Drain, yielding each plan's results as soon as its launch
        finishes — callers overlap their own post-processing with the
        remaining launches.  Under ``pipelined=True`` (on an engine with
        the dispatch/harvest split) the drain double-buffers launches;
        same results, same per-plan yield boundaries.  A follower on a mesh
        yields the results of its part of the lead's drain."""
        if self._follower:
            for rid, r in self._follow():
                if not isinstance(r, BaseException):
                    yield rid, r
            return
        with self._session():
            if self.pipelined and self._can_pipeline:
                yield from self._stream_pipelined()
                return
            while self.pending():
                out = self._step()
                yield from out
                if not out and not self.queue and self.pending():
                    self._wait_for_retries()

    def drain(self) -> Dict[int, SearchResult]:
        """Run the whole queue — waiting out retry backoff — until every
        request has resolved; returns {rid: SearchResult} for every
        request ever completed (incl. prior drains)."""
        for _ in self.stream():
            pass
        return self.results


class AsyncDSEService:
    """Non-blocking front end: a worker thread drains a ``DSEService``.

    ``submit`` enqueues and returns a ``concurrent.futures.Future``
    immediately — it never waits on a launch in flight, because the
    worker holds the service lock only around ``_dispatch``/``_complete``
    (queue surgery), never around ``engine.execute``.  A request
    submitted mid-launch therefore joins the NEXT launch's packing, and
    under the priority/edf policies an urgent submission preempts every
    still-queued request at that boundary (the re-plan keeps the chunk
    sizes through the service's slot hints).  On CUDA the worker thread
    selects the card of the thread that built the service, so the
    engine's ``"cuda"`` means the same card in both.

    Future results are ``SearchResult``s, bit-identical to a synchronous
    ``DSEService`` drain of the same requests: scheduling only reorders
    self-contained searches.  Futures resolve on the worker thread, so a
    done-callback runs BEFORE the next dispatch — a deterministic hook
    for reacting mid-drain (the integration test submits its priority-0
    jump there).  ``paused=True`` admits submissions without launching
    until ``resume()`` — batch admission with a deterministic first plan.
    ``pipelined=True`` swaps the worker for a double-buffered loop
    (dispatch plan i+1 before harvesting plan i — see ``DSEService``);
    results and future-resolution order are unchanged.  Use as a context
    manager, or call ``close()``.

    On a mesh every rank builds the service and submits the same requests
    in the same order.  The lead's worker plans and sends each launch (and
    the resolutions made without one); the other ranks' workers run what
    they receive and resolve their futures by request id.  The lead's
    ``close`` ends the followers' workers, so every rank closes."""

    def __init__(
        self,
        *,
        engine: Optional[SearchEngine] = None,
        device="cuda",
        max_slots: int = 64,
        policy="fifo",
        clock=time.monotonic,
        paused: bool = False,
        retry: Optional[RetryPolicy] = None,
        partial_results: bool = False,
        result_cache=None,
        pipelined: Optional[bool] = None,
        mesh=None,
        prng: Optional[str] = None,
    ):
        self.service = DSEService(
            engine=engine, device=device, max_slots=max_slots, policy=policy,
            clock=clock, retry=retry, partial_results=partial_results,
            result_cache=result_cache, pipelined=pipelined, mesh=mesh, prng=prng,
        )
        # the card of the building thread, selected again in the worker
        dev = getattr(self.service.engine, "device", None)
        self._cuda_index: Optional[int] = None
        if isinstance(dev, torch.device) and dev.type == "cuda":
            self._cuda_index = (torch.cuda.current_device() if dev.index is None
                                else dev.index)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._run = threading.Event()
        if not paused:
            self._run.set()
        self._futures: Dict[int, Future] = {}
        # a follower's results that landed before its own submit of the rid
        self._early: Dict[int, object] = {}
        self._closed = False
        svc = self.service
        if svc._follower:
            loop = self._loop_follow
        else:
            loop = (self._loop_pipelined
                    if svc.pipelined and svc._can_pipeline else self._loop)

        def target():
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
            loop()

        self._worker = threading.Thread(
            target=target, name="dse-service", daemon=True
        )
        self._worker.start()

    @property
    def stats(self) -> ServiceStats:
        return self.service.stats

    @property
    def launch_log(self) -> List[List[int]]:
        return self.service.launch_log

    # ------------------------------------------------------------- admission
    def submit(self, req: SearchRequest, *, on_progress=None) -> Future:
        """Enqueue; returns a Future resolving to the SearchResult.
        Never blocks on device work — at most the queue lock.  A
        result-cache hit comes back as an ALREADY-RESOLVED future (the
        request never reaches the worker).  ``on_progress(rid, partial)``
        subscribes to the mid-search best-so-far stream (segmented
        engines only); callbacks run on the worker thread, between
        segment launches, and may themselves submit."""
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncDSEService is closed")
            rid = self.service.submit(req, on_progress=on_progress)
            fut: Future = Future()
            fut.rid = rid  # type: ignore[attr-defined]
            if self.service._follower:
                hit = self._early.pop(rid, None)
            else:
                hit = self.service.results.get(rid)
            if hit is None:
                self._futures[rid] = fut
                self._idle.clear()
        # a cache hit resolves OUTSIDE the lock (done-callbacks may submit)
        if hit is not None:
            _settle(fut, hit)
            if self.service.mesh is not None:
                self._wake.set()  # the lead's worker sends the hit on
            return fut
        self._wake.set()
        return fut

    def submit_all(self, reqs: Sequence[SearchRequest]) -> List[Future]:
        return [self.submit(r) for r in reqs]

    def pause(self):
        """Stop launching at the next launch boundary (in-flight work
        finishes); submissions keep queueing."""
        self._run.clear()

    def resume(self):
        self._run.set()
        self._wake.set()

    # --------------------------------------------------------------- serving
    def _loop(self):
        while True:
            self._wait(self._wake)
            self._wait(self._run)
            svc = self.service
            retry_wait = None
            with self._lock:
                if self._closed:
                    return
                swept = (svc._sweep_deadlines()
                         if svc.partial_results else [])
                partial_futs = [
                    (self._futures.pop(rid, None), res) for rid, res in swept
                ]
                d = svc._dispatch()
                if d is None:
                    nb = svc._next_retry_due()
                    if nb is None:
                        self._wake.clear()
                        if not self._futures:
                            self._idle.set()
                    else:
                        retry_wait = max(nb - svc.clock(), 0.0)
            # futures resolve OUTSIDE the lock: done-callbacks may submit
            for f, res in partial_futs:
                if f is not None:
                    f.set_result(res)
            if d is None:
                self._send_resolutions()
                if retry_wait is not None:
                    # backed-off retries pending: nap on the REAL clock (a
                    # virtual service clock advances externally), bounded
                    # so external clock advances are picked up promptly
                    time.sleep(min(retry_wait, 0.05) or 0.001)
                continue
            plan, rids, t0 = d
            # the launch runs WITHOUT the lock: submits land concurrently
            # and join the next dispatch's re-plan (progress callbacks
            # fire here too — lock-free, so they may submit)
            try:
                results = svc._execute(plan, rids, svc._progress_kw(rids))
            except BaseException as e:  # noqa: BLE001 — fail the futures, keep serving
                with self._lock:
                    if svc.retry is None:
                        self.service._abandon(rids)
                        resolved = []
                        failed = [self._futures.pop(rid, None) for rid in rids]
                    else:
                        res2, bad = svc._handle_failure(plan, rids, e)
                        resolved = [
                            (self._futures.pop(rid, None), res)
                            for rid, res in res2
                        ]
                        failed = [self._futures.pop(rid, None) for rid in bad]
                # exceptions set OUTSIDE the lock: done-callbacks fire on
                # failure too, and they may submit (which takes the lock)
                for f, res in resolved:
                    if f is not None:
                        f.set_result(res)
                for f in failed:
                    if f is not None:
                        f.set_exception(e)
                continue
            with spans.span("serve.complete"):
                with self._lock:
                    done = svc._complete(rids, results, svc.clock() - t0,
                                         plan.requests)
                    futs = [(self._futures.pop(rid, None), res) for rid, res in done]
                # resolve OUTSIDE the lock: done-callbacks may submit
                for f, res in futs:
                    if f is not None:
                        f.set_result(res)

    def _loop_pipelined(self):
        """The double-buffered worker: dispatch plan i+1 (lock-free — the
        device starts computing), then harvest plan i (the blocking sync).
        Queue surgery and stats stay under the lock exactly as in
        ``_loop``; futures always resolve outside it.  ``pause()`` and
        ``close()`` both finish the in-flight launch before stopping."""
        svc = self.service

        def fail_rids(plan, rids, e):
            """Failure bookkeeping shared by dispatch and harvest faults
            (the async twin of step()'s except-arm): returns the futures
            to resolve/fail, computed under the lock."""
            if svc.retry is None:
                svc._abandon(rids)
                resolved = []
                failed = [self._futures.pop(rid, None) for rid in rids]
            else:
                res2, bad = svc._handle_failure(plan, rids, e)
                resolved = [(self._futures.pop(rid, None), r)
                            for rid, r in res2]
                failed = [self._futures.pop(rid, None) for rid in bad]
            return resolved, failed

        def harvest_entry(entry):
            plan, rids, t0, pend, td = entry
            th = svc.clock()
            try:
                results = svc._harvest(pend)
            except BaseException as e:  # noqa: BLE001 — fail the futures, keep serving
                with self._lock:
                    svc._inflight -= 1
                    if svc._inflight == 0:
                        svc._last_harvest_end = svc.clock()
                    resolved, failed = fail_rids(plan, rids, e)
                for f, r in resolved:
                    if f is not None:
                        f.set_result(r)
                for f in failed:
                    if f is not None:
                        f.set_exception(e)
                return
            with spans.span("serve.complete"):
                te = svc.clock()
                with self._lock:
                    svc.stats.dispatch_gap_samples.append(max(0.0, th - td))
                    svc._inflight -= 1
                    if svc._inflight == 0:
                        svc._last_harvest_end = te
                    done = svc._complete(rids, results, (td - t0) + (te - th),
                                         plan.requests)
                    futs = [(self._futures.pop(rid, None), r) for rid, r in done]
                for f, r in futs:
                    if f is not None:
                        f.set_result(r)

        prev = None  # (plan, rids, t0, pending, td) still in flight
        while True:
            if prev is None:
                self._wait(self._wake)
                self._wait(self._run)
            elif not self._run.is_set():
                # paused mid-overlap: settle the in-flight launch, then
                # block at the top of the next iteration
                to_harvest, prev = prev, None
                harvest_entry(to_harvest)
                continue
            retry_wait = None
            d = None
            with self._lock:
                if self._closed:
                    break
                swept = (svc._sweep_deadlines()
                         if svc.partial_results else [])
                partial_futs = [
                    (self._futures.pop(rid, None), res) for rid, res in swept
                ]
                d = svc._dispatch()
                if d is None:
                    nb = svc._next_retry_due()
                    if nb is None and prev is None:
                        self._wake.clear()
                        if not self._futures:
                            self._idle.set()
                    elif nb is not None:
                        retry_wait = max(nb - svc.clock(), 0.0)
                else:
                    plan, rids, t0 = d
                    if (svc._inflight == 0
                            and svc._last_harvest_end is not None):
                        svc.stats.device_idle_s += max(
                            0.0, t0 - svc._last_harvest_end)
            for f, res in partial_futs:
                if f is not None:
                    f.set_result(res)
            if d is None:
                if prev is not None:
                    to_harvest, prev = prev, None
                    harvest_entry(to_harvest)
                    continue
                self._send_resolutions()
                if retry_wait is not None:
                    time.sleep(min(retry_wait, 0.05) or 0.001)
                continue
            # dispatch WITHOUT the lock: it only enqueues device work
            # (progress callbacks fire here too, and may submit)
            try:
                pend = svc._launch(plan, rids, svc._progress_kw(rids))
            except BaseException as e:  # noqa: BLE001 — fail the futures, keep serving
                with self._lock:
                    resolved, failed = fail_rids(plan, rids, e)
                for f, r in resolved:
                    if f is not None:
                        f.set_result(r)
                for f in failed:
                    if f is not None:
                        f.set_exception(e)
                continue
            td = svc.clock()
            with self._lock:
                svc._inflight += 1
            cur = (plan, rids, t0, pend, td)
            if prev is not None:
                to_harvest, prev = prev, cur
                harvest_entry(to_harvest)
            else:
                prev = cur
        # closed with a launch still in flight (timed-out close cancelled
        # its futures): settle it so engine bookkeeping stays consistent —
        # the pops above see an empty future map and skip
        if prev is not None:
            harvest_entry(prev)

    def _wait(self, event: threading.Event) -> None:
        """Wait for ``event``.  On a mesh the lead's idle worker messages
        the followers every ``HEARTBEAT_S`` meanwhile, so their waits never
        reach their groups' timeout."""
        svc = self.service
        if svc.mesh is None:
            event.wait()
            return
        while not event.wait(HEARTBEAT_S):
            svc._send("resolve")

    def _send_resolutions(self) -> None:
        """The lead's worker, going idle: send the followers what it
        resolved without a launch (cache hits, partials, failures)."""
        svc = self.service
        if svc.mesh is not None and svc._unsent:
            svc._send("resolve")

    def _loop_follow(self):
        """A follower's worker: run the lead's launches and resolve this
        rank's futures by rid until the lead closes."""
        try:
            for rid, res in self.service._follow():
                with self._lock:
                    fut = self._futures.pop(rid, None)
                    if fut is None:
                        self._early[rid] = res
                    elif not self._futures:
                        self._idle.set()
                if fut is not None:
                    _settle(fut, res)
        except BaseException as e:  # noqa: BLE001 - fail the futures left
            with self._lock:
                left = list(self._futures.values())
                self._futures.clear()
                self._idle.set()
            for f in left:
                f.set_exception(e)

    def drain(self, timeout: Optional[float] = None) -> Dict[int, SearchResult]:
        """Block until the queue and all in-flight launches are done;
        returns the service's full {rid: result} map.  On timeout raises
        ``TimeoutError`` naming every unresolved rid."""
        if not self._idle.wait(timeout):
            with self._lock:
                unresolved = sorted(self._futures)
            raise TimeoutError(
                f"drain timed out with {len(unresolved)} unresolved "
                f"rids: {unresolved}"
            )
        return self.service.results

    def close(self, timeout: Optional[float] = None):
        """Finish in-flight work, then stop the worker.  Idempotent — a
        second close is a no-op.  With ``timeout``, a drain that cannot
        finish in time stops waiting and CANCELS every unresolved future
        (``Future.result()`` then raises ``CancelledError``), so a close
        racing an in-flight launch still leaves no future dangling."""
        with self._lock:
            if self._closed:
                return
        if self._run.is_set():
            try:
                self.drain(timeout)
            except TimeoutError:
                pass  # leftovers are cancelled below
        with self._lock:
            self._closed = True
            leftovers = list(self._futures.values())
            self._futures.clear()
        self._run.set()
        self._wake.set()
        # cancel BEFORE joining: the worker may still be inside a launch
        # (its pops see an empty future map and skip), and callers
        # blocked on result() unblock without waiting the launch out
        for f in leftovers:
            f.cancel()
        if threading.current_thread() is not self._worker:
            self._worker.join()
            if self.service.mesh is not None and not self.service._follower:
                self.service._send("stop", None)  # ends the followers' workers

    def __enter__(self) -> "AsyncDSEService":
        return self

    def __exit__(self, *exc):
        self.close()


def _settle(fut: Future, res) -> None:
    if isinstance(res, BaseException):
        fut.set_exception(res)
    else:
        fut.set_result(res)


def paper_request_mix(
    ws: WorkloadSet,
    n: int,
    *,
    backend: str = "table",
    pop_size: int = 40,
    generations: int = 10,
    area_constr: float = 150.0,
    seed0: int = 0,
    priorities: Optional[Sequence[int]] = None,
    deadlines_s: Optional[Sequence[Optional[float]]] = None,
) -> List[SearchRequest]:
    """N heterogeneous requests over ``ws``: cycles through workload
    subsets (full set, singles, pairs) x objective kinds x seeds, the
    service's canonical mixed traffic (``launch.search --serve``, the
    service phase of ``chip_smoke.py``).  ``priorities`` /
    ``deadlines_s`` cycle the same way, for mixed-priority / EDF
    traffic."""
    W = ws.n
    subsets = [tuple(range(W))]
    subsets += [(i,) for i in range(W)]
    subsets += [(i, (i + 1) % W) for i in range(W)] if W > 1 else []
    return [
        SearchRequest(
            ws=ws.subset(list(subsets[i % len(subsets)])),
            objective=OBJECTIVES[i % len(OBJECTIVES)],
            area_constr=area_constr,
            seed=seed0 + i,
            backend=backend,
            pop_size=pop_size,
            generations=generations,
            priority=0 if priorities is None else int(priorities[i % len(priorities)]),
            deadline_s=None if deadlines_s is None
            else deadlines_s[i % len(deadlines_s)],
        )
        for i in range(n)
    ]
