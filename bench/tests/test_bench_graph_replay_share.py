"""``graph_replay_share.ga`` on hand-made span records: every generation
replayed, none, some, no generation at all (``None``), and a program
without captured generations (``None``).  On the card (``-m gpu``): a
traced ``cnn4-sweep-kernel`` call whose generations all replay, with B1's
operator calls still in the trace, their shapes joined to their kernels,
so ``imc_eval_roofline`` reads a number."""
import sys
import types
from typing import NamedTuple

import pytest

from bench.harness.spec import Spec

METRIC = "graph_replay_share.ga"


class Record(NamedTuple):  # the fields of repro_torch.spans.Record read here
    name: str
    start_ns: int
    dur_ns: int


class Trace(NamedTuple):
    window_s: float


class Run(NamedTuple):
    traces: list


SLICE_RUN = Run(traces=[Trace(window_s=1.0)])


def _program(monkeypatch, counts, captured=True):
    """A program whose registry holds ``counts`` (name -> number) of 1 ms
    spans inside the slice; ``captured``: its GA has captured generations."""
    recs = [Record(name, 1_000_000 + i * 1000, 1_000_000)
            for name, n in counts.items() for i in range(n)]
    mod = types.ModuleType("repro_torch.spans")
    mod.records = lambda: list(recs)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", mod)
    ga = types.ModuleType("repro_torch.core.ga")
    if captured:
        ga.GRAPH_CACHE_KEYS = 8
    monkeypatch.setitem(sys.modules, "repro_torch.core.ga", ga)
    import repro_torch

    monkeypatch.setattr(repro_torch, "spans", mod, raising=False)


@pytest.mark.parametrize("counts,expected", [
    ({"ga.generation": 90, "ga.graph_replay": 90}, 100.0),
    ({"ga.generation": 90}, 0.0),
    ({"ga.generation": 40, "ga.graph_replay": 10}, 25.0),
    ({"engine.dispatch": 9}, None),
    ({}, None),
], ids=["all", "none", "some", "no_generation", "no_spans"])
def test_reader_arithmetic(monkeypatch, counts, expected):
    _program(monkeypatch, counts)
    got = Spec().reader(METRIC)(SLICE_RUN)
    assert got == (None if expected is None else pytest.approx(expected))


def test_reader_reads_none_on_a_program_without_captured_generations(monkeypatch):
    _program(monkeypatch, {"ga.generation": 90}, captured=False)
    assert Spec().reader(METRIC)(SLICE_RUN) is None


def test_the_metric_is_a_ga_span_metric_of_the_kernel_sweep():
    spec = Spec()
    [m] = [m for m in spec.data["per_layer"] if m["name"] == METRIC]
    assert m["workloads"] == ["cnn4-sweep-kernel"] and m["moves"] == "device_ms_per_search"
    assert m["layer"] == next(x["layer"] for x in spec.data["per_layer"]
                              if x["name"] == "gen_ms.ga")
    assert callable(spec.reader(METRIC))


@pytest.mark.gpu
def test_a_traced_call_replays_every_generation_and_sees_b1():
    """After a warm-up call (each shape seen once) and a call that captures
    them, a traced call replays every generation; each replayed generation
    still makes one ``repro_torch::imc_eval`` operator call, which the
    trace joins to its kernel with its shapes."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from bench.drivers.sweep import Driver
    from bench.harness import trace
    from bench.harness.record import Run as Record_
    from repro_torch import spans
    from repro_torch.core import ga
    from repro_torch.kernels.imc_eval.ops import imc_eval_multi

    spec = Spec()
    cell = spec.cell("cnn4-sweep-kernel")
    sweep = Driver(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                   2 ** 31 + 733, torch.device("cuda:0"))
    ga.GRAPHS.clear()
    sweep.warmup()
    sweep.call(0, keep=False)  # the second sighting: captures
    spans.reset()
    out = []
    before = imc_eval_multi.launches
    with trace.traced(out):
        sweep.call(1, keep=False)
    launches = imc_eval_multi.launches - before
    [t] = out
    run = Record_(searches=0, window_s=t.window_s, counters={}, traces=out,
                  b1_layers=sweep.b1_layers)
    snap = spans.snapshot()
    gens = snap["ga.generation"]["count"]
    assert gens == 90 and snap["ga.graph_replay"]["count"] == gens
    assert "ga.graph_capture" not in snap
    assert spec.reader(METRIC)(run) == pytest.approx(100.0)
    b1 = [x for x in t.launches if x.op == "repro_torch::imc_eval"]
    assert len(b1) == launches >= gens
    assert {tuple(x.shapes[0]) for x in b1} == {(8, 40, 9), (4, 40, 9)}
    roof = spec.reader("imc_eval_roofline")(run)
    assert roof is not None and 0.0 < roof < 100.0
