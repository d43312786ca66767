"""The port's spans (``repro_torch.spans``) on the CPU.

  * Off (no profiler): nothing recorded, no ``record_function``, no clock
    read, one object per name; the body and a decorated function run.
  * On (``torch.profiler.profile``): a small ``SearchEngine.run`` records
    the engine's spans with their parents and launch keys, sequential and
    pipelined, each matched by a ``repro_torch.*`` profiler event.
  * An ``AsyncDSEService`` drain records the service's and the engine's
    spans from its worker thread (the profiler's flag is read process-wide).
  * Results are bit for bit the same with the profiler on and off.
  * The registry counts exactly under many threads; self <= inclusive.
  * ``launch/search.py --profile`` writes a Chrome trace and the span table.
"""
from __future__ import annotations

import collections
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import search
from repro_torch.core.engine import SearchEngine, SearchRequest
from repro_torch.launch import search as cli
from repro_torch.serve.dse import AsyncDSEService, DSEService
from repro_torch.workloads.cnn import cnn_workload
from repro_torch.workloads.pack import pack_workloads

CPU = torch.device("cpu")
G = 2
ENGINE_PARENTS = {
    "engine.plan": None,
    "engine.dispatch": None,
    "engine.prepare": "engine.dispatch",
    "engine.seed": "engine.prepare",
    "engine.seed_round": "engine.seed",
    "ga.generation": "engine.dispatch",
    "engine.harvest": None,
    "engine.sync": "engine.harvest",
    "engine.finalize": "engine.harvest",
}


@pytest.fixture(autouse=True)
def fresh_registry():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture(scope="module")
def ws():
    return pack_workloads([(n, cnn_workload(n)) for n in ("alexnet", "resnet18")])


def _requests(ws, backend="dense"):
    return [SearchRequest(ws=ws, backend=backend, pop_size=8, generations=G, seed=s,
                          area_constr=150.0) for s in (3, 4)]


def _profiler():
    from torch._C._profiler import _ExperimentalConfig

    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def _event_counts(prof) -> collections.Counter:
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith(spans.PREFIX))


def _same(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in (
        (a.top_genomes, b.top_genomes), (a.top_scores, b.top_scores),
        (a.convergence, b.convergence)))


def test_off_records_nothing_and_runs_the_body(monkeypatch):
    def refused(*a, **kw):
        raise AssertionError("touched while no profiler runs")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(time, "perf_counter_ns", refused)
    ran = []
    with spans.span("engine.dispatch", key=7):
        ran.append(1)

    @spans.span("engine.finalize")
    def finalize(x):
        return x + 1

    assert finalize(1) == 2 and ran == [1]
    assert spans.span("engine.sync") is spans.span("engine.sync", key=3)
    assert spans.snapshot() == {} and spans.records() == []


@pytest.mark.parametrize("pipelined", [False, True])
def test_engine_run_records_its_spans(ws, pipelined):
    eng = SearchEngine(device=CPU, pipelined=pipelined)
    with _profiler() as prof:
        eng.run(_requests(ws))
    snap = spans.snapshot()
    assert set(snap) == set(ENGINE_PARENTS) | {"tables.build"}
    launches = snap["engine.dispatch"]["count"]
    assert launches == eng.launches == 1
    assert snap["ga.generation"]["count"] == G * launches
    assert snap["engine.seed_round"]["count"] >= 1
    assert snap["engine.sync"]["count"] >= 2  # the seeding check and the results
    parents = dict(ENGINE_PARENTS)
    if pipelined:  # a pipelined run seeds every plan before its launches
        parents["engine.prepare"] = None
    for r in spans.records():
        assert r.self_ns <= r.dur_ns
        if r.name == "tables.build":
            assert r.key == "packed" and r.parent == "engine.prepare"
            continue
        assert r.parent == parents[r.name], r
        assert r.key == (None if r.name == "engine.plan" else 1), r
    for name, v in snap.items():
        assert v["self_s"] <= v["total_s"]
    assert _event_counts(prof) == {spans.PREFIX + n: v["count"] for n, v in snap.items()}


def test_drivers_record_their_spans(ws):
    eng = SearchEngine(device=CPU)
    with _profiler():
        search.joint_search_batched([1, 2], ws, pop_size=8, generations=G, backend="dense",
                                    device=CPU, engine=eng)
        sep = search.separate_search(5, ws, pop_size=8, generations=G, backend="dense",
                                     device=CPU, engine=eng)
        r = next(iter(sep.values()))
        search.rescore_designs(r.top_genomes, ws, device=CPU)
    snap = spans.snapshot()
    assert {n: snap[n]["count"] for n in ("search.joint", "search.separate",
                                          "search.rescore", "engine.dispatch")} == {
        "search.joint": 1, "search.separate": 1, "search.rescore": 1, "engine.dispatch": 2}
    by_name = collections.defaultdict(set)
    for r in spans.records():
        by_name[r.name].add(r.parent)
    assert by_name["engine.dispatch"] == {"search.joint", "search.separate"}
    assert by_name["search.rescore"] == {None}


def test_async_service_records_from_its_worker(ws):
    main = threading.get_ident()
    eng = SearchEngine(device=CPU, pipelined=True, max_slots=2)
    with _profiler() as prof:
        with AsyncDSEService(engine=eng, pipelined=True) as svc:
            futs = [svc.submit(r) for r in _requests(ws, "table") + _requests(ws, "table")[:1]]
            [f.result(timeout=300) for f in futs]
    snap = spans.snapshot()
    for name in ("serve.submit", "serve.schedule", "serve.complete", "engine.dispatch",
                 "engine.harvest", "ga.generation"):
        assert snap.get(name, {}).get("count", 0) >= 1, (name, snap)
    assert snap["serve.submit"]["count"] == 3
    assert snap["engine.dispatch"]["count"] == eng.launches == 2
    threads = {r.name: r.thread for r in spans.records()}
    assert threads["serve.submit"] == main
    assert threads["engine.dispatch"] != main and threads["serve.complete"] != main
    keys = sorted(r.key for r in spans.records() if r.name == "serve.submit")
    assert keys == [0, 1, 2]
    assert _event_counts(prof)[spans.PREFIX + "engine.dispatch"] == 2


def test_results_are_the_same_bits_with_the_profiler_on(ws):
    off = SearchEngine(device=CPU).run(_requests(ws))
    with _profiler():
        on = SearchEngine(device=CPU).run(_requests(ws))
    assert spans.snapshot()["engine.dispatch"]["count"] == 1
    assert all(_same(a, b) and np.array_equal(a.ga.genomes, b.ga.genomes)
               for a, b in zip(off, on))
    svc_off = DSEService(device=CPU, pipelined=True)
    svc_off.submit_all(_requests(ws, "table"))
    with _profiler():
        svc_on = DSEService(device=CPU, pipelined=True)
        svc_on.submit_all(_requests(ws, "table"))
        res_on = svc_on.drain()
    res_off = svc_off.drain()
    assert sorted(res_off) == sorted(res_on) == [0, 1]
    assert all(_same(res_off[k], res_on[k]) for k in res_off)


def test_registry_counts_exactly_under_many_threads():
    n_threads, n_spans = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _profiler():
            start = threading.Barrier(n_threads)

            def work():
                start.wait(timeout=60)
                for i in range(n_spans):
                    with spans.span("engine.dispatch", key=i):
                        with spans.span("engine.sync"):
                            pass
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = spans.snapshot()
    assert snap["engine.dispatch"]["count"] == snap["engine.sync"]["count"] == n_threads * n_spans
    recs = spans.records()
    assert all(r.parent == "engine.dispatch" for r in recs if r.name == "engine.sync")
    per_thread = collections.Counter(r.thread for r in recs if r.name == "engine.sync")
    assert sorted(per_thread.values()) == [n_spans] * n_threads
    assert all(r.self_ns <= r.dur_ns for r in recs)
    # a child inherits its parent's key
    assert all(r.key is not None for r in recs)


def test_cli_profile_writes_a_trace_and_the_span_table(tmp_path, capsys):
    out = tmp_path / "trace.json"
    assert cli.main(["--device", "cpu", "--workloads", "alexnet", "--pop", "8", "--gens",
                     str(G), "--backend", "table", "--profile", str(out)]) == 0
    text = capsys.readouterr().out
    names = {e.get("name") for e in json.loads(out.read_text())["traceEvents"]}
    assert {"repro_torch.search.joint", "repro_torch.engine.dispatch"} <= names
    table = text[text.index("[profile]"):].splitlines()
    assert table[1].split() == ["span", "count", "total", "ms", "self", "ms"]
    rows = {r.split()[0]: r.split()[1:] for r in table[2:]}
    assert rows["repro_torch.ga.generation"][0] == str(G)
    assert rows["repro_torch.engine.dispatch"][0] == "1"


def test_serve_summary_calls_the_estimate_what_it_is(capsys):
    assert cli.main(["--device", "cpu", "--workloads", "alexnet", "--serve", "2", "--pop",
                     "8", "--gens", str(G), "--backend", "table"]) == 0
    text = capsys.readouterr().out
    assert "no launch in flight (host estimate)" in text and "device idle" not in text
    assert spans.snapshot() == {}
