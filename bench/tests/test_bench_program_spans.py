"""The per-layer metrics that read the program's spans, on hand-made
records: their arithmetic, the cut at the traced slice's end, and ``None``
where nothing was recorded or the program has no ``repro_torch.spans`` (a
tree older than the spans).  On the card (``-m gpu``): one traced sweep
call's spans against the profiler's events."""
import collections
import sys
import types
from typing import NamedTuple

import pytest

from bench.harness.spec import Spec

# name -> (count, inclusive ms of each)
SLICE = {
    "engine.dispatch": (4, 50.0),
    "engine.seed": (4, 10.0),
    "engine.seed_round": (6, 6.0),
    "ga.generation": (40, 3.0),
    "engine.sync": (8, 1.0),
    "engine.finalize": (4, 3.0),
    "search.rescore": (32, 3.0),
    "serve.submit": (256, 0.25),
}
EXPECTED = {
    "seed_ms_per_launch.engine": 10.0,  # 40 ms over 4 launches
    "seed_rounds_per_launch.engine": 1.5,
    "gen_ms.ga": 3.0,
    "sync_ms_per_launch.engine": 2.0,
    "finalize_ms_per_launch.engine": 3.0,
    "rescore_ms.drivers": 3.0,
    "submit_ms.serve": 0.25,
}


class Record(NamedTuple):  # the fields of repro_torch.spans.Record read here
    name: str
    start_ns: int
    dur_ns: int


class Trace(NamedTuple):
    window_s: float


class Run(NamedTuple):
    traces: list


SLICE_RUN = Run(traces=[Trace(window_s=1.0)])


def _records(spans, t0=1_000_000):
    """Back-to-back records of each name from ``t0`` on (every one inside a
    1 s slice)."""
    return [Record(name, t0 + i * 1000, int(ms * 1e6))
            for name, (n, ms) in spans.items() for i in range(n)]


def _program(monkeypatch, records):
    mod = types.ModuleType("repro_torch.spans")
    mod.records = lambda: list(records)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", mod)
    import repro_torch

    monkeypatch.setattr(repro_torch, "spans", mod, raising=False)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_arithmetic(monkeypatch, metric):
    _program(monkeypatch, _records(SLICE))
    read = Spec().reader(metric)
    assert read(SLICE_RUN) == pytest.approx(EXPECTED[metric])
    assert read(Run(traces=[])) == pytest.approx(EXPECTED[metric])  # nothing to cut at


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_leaves_out_spans_that_end_after_the_slice(monkeypatch, metric):
    """A span the profiler's stop held open (the service's worker) ends
    after the slice, with the stop's seconds in it: it is not read."""
    held = [Record(name, 1_000_000 + 999_000_000, 3_000_000_000) for name in SLICE]
    _program(monkeypatch, _records(SLICE) + held)
    assert Spec().reader(metric)(SLICE_RUN) == pytest.approx(EXPECTED[metric])


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_reads_none_without_spans(monkeypatch, metric):
    read = Spec().reader(metric)
    _program(monkeypatch, [])
    assert read(SLICE_RUN) is None
    import repro_torch

    monkeypatch.delattr(repro_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)  # import fails
    assert read(SLICE_RUN) is None


def test_per_launch_readers_read_zero_where_the_span_never_ran(monkeypatch):
    _program(monkeypatch, _records({"engine.dispatch": SLICE["engine.dispatch"]}))
    spec = Spec()
    assert spec.reader("seed_rounds_per_launch.engine")(SLICE_RUN) == 0.0
    assert spec.reader("seed_ms_per_launch.engine")(SLICE_RUN) == 0.0
    assert spec.reader("gen_ms.ga")(SLICE_RUN) is None


def test_every_span_metric_names_a_reader_and_its_cells():
    spec = Spec()
    cells = {w["name"] for w in spec.data["workloads"]}
    for m in spec.data["per_layer"]:
        if m["source"] == "program_span" and m["name"] in EXPECTED:
            assert callable(spec.reader(m["name"]))
            assert set(m["workloads"]) <= cells and m["moves"] == "searches_per_s"


def _match(records, events):
    """Pair the registry's records with the profiler's ``repro_torch.``
    events: per thread and name, in start order; returns (record, event)
    pairs, each thread of one side mapped to the thread of the other with
    the same sequence of names."""
    def by_thread(items, thread, name, start):
        out = collections.defaultdict(list)
        for x in sorted(items, key=start):
            out[thread(x)].append(x)
        return {t: (tuple(name(x) for x in xs), xs) for t, xs in out.items()}

    recs = by_thread(records, lambda r: r.thread, lambda r: r.name, lambda r: r.start_ns)
    evs = by_thread(events, lambda e: e.start_thread_id(),
                    lambda e: e.name()[len("repro_torch."):], lambda e: e.start_ns())
    pairs = []
    for names, rs in recs.values():
        match = [es for n, es in evs.values() if n == names]
        assert match, f"no profiler thread has the registry's spans {names[:5]}..."
        pairs += list(zip(rs, match[0]))
    return pairs


@pytest.mark.gpu
def test_spans_agree_with_the_profiler_on_the_card():
    """One traced ``cnn4-sweep-kernel`` call: each registry span has a
    profiler event of its name on its thread, within 5% or 10 us; the
    card's idle time that no host operation names ("Python between
    operations") is under 10% of the slice, and the program's spans name
    more of it than any other single name does."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench.drivers.sweep import Driver
    from bench.harness import trace
    from repro_torch import spans

    spec = Spec()
    cell = spec.cell("cnn4-sweep-kernel")
    driver = Driver(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                    2 ** 31 + 401, torch.device("cuda:0"))
    driver.warmup()
    spans.reset()
    out, events = [], []
    real = trace.summarize

    def keep(evs):
        events.extend(evs)
        return real(evs)

    trace.summarize = keep
    try:
        with trace.traced(out):
            driver.call(0)
    finally:
        trace.summarize = real
    records = spans.records()
    ours = [e for e in events if e.name().startswith("repro_torch.")
            and e.device_type() == torch.autograd.DeviceType.CPU]
    assert records and len(records) == len(ours)
    for r, e in _match(records, ours):
        dur_e = e.duration_ns()
        assert abs(r.dur_ns - dur_e) <= max(0.05 * dur_e, 10_000), (r, dur_e)
    [t] = out
    gaps = dict(t.idle_gaps)
    assert gaps.get("host: Python between operations", 0.0) < 0.1 * t.window_s, t.idle_gaps
    by_spans = sum(v for k, v in gaps.items() if k.startswith("repro_torch."))
    assert by_spans > max(v for k, v in gaps.items() if not k.startswith("repro_torch.")), gaps
