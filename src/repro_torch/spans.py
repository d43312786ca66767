"""Spans at the port's layer boundaries, on the profiler's clock.

    with spans.span("engine.dispatch", key=launch):
        ...

    @spans.span("engine.finalize")
    def _finalize_batch(...): ...

A span records only while a ``torch.profiler`` runs in the process: at
entry it reads ``torch.autograd.profiler._is_profiler_enabled``, the
process-wide flag (``torch._C._autograd._profiler_enabled()`` is per
thread and reads ``False`` on the service's worker thread), fresh each
time.  Off, that read is all it does: no ``record_function``, no clock
read, no allocation (the context manager is a per-name object made once).
The profiler is the only switch.

On, a span opens a profiler record function named ``repro_torch.<name>``,
so it is a host event on kineto's clock, the clock of the card's activity,
and it adds a ``Record`` to an in-memory registry: its name, its key, the
span open around it on the same thread (its parent), the thread, and its
inclusive and self host time (self: inclusive minus the child spans on
the same thread).  A span given no key takes its parent's, so the spans
inside one launch carry its launch number.  The registry is safe under
several threads and grows by one record a span while the profiler runs.
``records()`` lists it; ``snapshot()`` sums it by name; ``reset()``
empties it.

The names (``repro_torch.`` + name in a trace):

==================== =====================================================
``search.joint``     ``core.search.joint_search_batched``
``search.separate``  ``core.search.separate_search``
``search.rescore``   ``core.search.rescore_designs``, its host read included
``serve.submit``     ``serve.dse.DSEService.submit`` (key: the rid)
``serve.schedule``   ``DSEService._dispatch``: queue snapshot, policy, re-plan
``serve.complete``   a finished launch's bookkeeping and its futures'
                     resolution (the clients' callbacks)
``engine.plan``      ``core.engine.plan_batch``
``engine.prepare``   ``SearchEngine._prepare``: tables, eval context, draws
``engine.seed``      seeding a plan (the rejection rounds or the direct seeder)
``engine.seed_round`` one rejection round, its host read included
``tables.build``     a memo miss that builds or uploads a table (key: which
                     memo)
``engine.dispatch``  one launch (key: ``SearchEngine.launches`` after it)
``ga.generation``    the host's enqueue of one GA generation
``ga.graph_replay``  in ``ga.generation``: a generation replayed from CUDA
                     graphs (``core.ga.CapturePlan``)
``ga.graph_capture`` in ``ga.graph_replay``: the capture of a shape's
                     graphs (key: the populations' shape)
``engine.harvest``   the host half of a launch
``engine.sync``      the host blocked on a staged device-to-host copy
``engine.finalize``  host finalize of a launch's results
==================== =====================================================

No span reads the device or synchronises, and none changes a result.
A span that another thread holds open while the profiler stops ends after
the stop, with the stop's seconds in it (on an H100's host, a 3.3 s
``engine.seed_round`` of the service's worker after a 2 s slice):
``records()`` carries each span's start and length, so a reader can keep
the spans that end inside its window.

The record function is ``torch._C._profiler._RecordFunctionFast``, the
one ``torch.profiler.record_function`` wraps without its operator call:
on a CPU it costs some 2 us a span against 16, and its event lasts what
the registry measures within a few us, where ``record_function``'s event
strayed from it by up to 1.5 ms.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."


class Record(NamedTuple):
    name: str
    key: object
    parent: Optional[str]
    thread: int  # ``threading.get_ident()``
    start_ns: int  # ``time.perf_counter_ns()`` at entry
    dur_ns: int  # inclusive
    self_ns: int  # inclusive minus the child spans on the same thread


_lock = threading.Lock()
_records: List[Record] = []
_local = threading.local()  # .stack: the open spans of this thread
_off: Dict[str, "_Off"] = {}


class _Decorates:
    __slots__ = ()

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _On(name, None):
                return fn(*args, **kwargs)
        return traced


class _Off(_Decorates):
    """A span while no profiler runs: does nothing."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


class _On(_Decorates):
    """A span while a profiler runs."""

    __slots__ = ("name", "key", "_rf", "_t0", "_child_ns")

    def __init__(self, name: str, key):
        self.name = name
        self.key = key

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if self.key is None and stack:
            self.key = stack[-1].key
        stack.append(self)
        self._child_ns = 0
        self._rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter_ns() - self._t0
        self._rf.__exit__(exc_type, exc, tb)
        stack = _local.stack
        stack.pop()
        parent = stack[-1] if stack else None
        if parent is not None:
            parent._child_ns += dur
        rec = Record(self.name, self.key, None if parent is None else parent.name,
                     threading.get_ident(), self._t0, dur, dur - self._child_ns)
        with _lock:
            _records.append(rec)
        return False


def span(name: str, key=None):
    """A span named ``name`` (``repro_torch.<name>`` in a trace): a context
    manager, or a decorator of a function (its key: its parent's)."""
    if _profiler._is_profiler_enabled:
        return _On(name, key)
    off = _off.get(name)
    if off is None:
        off = _off[name] = _Off(name)
    return off


def records() -> List[Record]:
    """The spans recorded since the last ``reset``, in the order they ended."""
    with _lock:
        return list(_records)


def snapshot() -> Dict[str, Dict[str, float]]:
    """Per span name: ``count``, ``total_s`` (inclusive) and ``self_s``,
    over ``records()``."""
    out: Dict[str, Dict[str, float]] = {}
    for r in records():
        s = out.setdefault(r.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += r.dur_ns / 1e9
        s["self_s"] += r.self_ns / 1e9
    return out


def reset() -> None:
    with _lock:
        _records.clear()
