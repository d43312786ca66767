"""The reduction of a traced slice, on hand-made profiler events."""
import torch

from bench.harness import trace
from bench.harness.spec import Spec

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Event:
    def __init__(self, name, a, b, dev=CPU, corr=0, link=0, shapes=(), annotation=False):
        self._v = (name, a, b, dev, corr, link, list(shapes), annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def shapes(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


B2_SHAPES = [[64, 40, 9], [64, 40], [64, 1180], [64, 4, 5, 5, 4], [64, 4, 5, 4], [64, 4, 10]]


def events():
    return [
        Event(trace.WINDOW_SPAN, 0, 1000),
        Event(trace.WINDOW_SPAN, 0, 1000, dev=CUDA, annotation=True),  # mirrored span
        Event("outer", 100, 400),
        Event("repro_torch::ga_gen_step", 150, 250, corr=7, shapes=B2_SHAPES),
        Event("void ga_gen_step_kernel<40>(float*)", 300, 500, dev=CUDA, link=7),
        Event("elementwise_kernel", 450, 600, dev=CUDA, link=9),
    ]


def test_union_gaps_and_launches():
    t = trace.summarize(events())
    assert t.window_s == 1e-6 and t.busy_s == 300e-9  # union of [300, 600]
    assert dict(t.idle_gaps) == {"repro_torch::ga_gen_step": 300e-9,
                                 "host: Python between operations": 400e-9}
    assert dict(t.device_ops) == {"ga_gen_step_kernel": 200e-9, "elementwise_kernel": 150e-9}
    [x] = t.launches
    assert x.op == "repro_torch::ga_gen_step" and x.shapes == B2_SHAPES
    assert abs(x.device_s - 200e-9) < 1e-18


def test_readers_on_the_slice():
    from bench.harness.record import Run
    from bench.harness import yardstick

    t = trace.summarize(events())
    run = Run(searches=100, window_s=1.0, counters={"launches": 2, "transfer_bytes": 46000},
              traces=[t])
    spec = Spec()
    idle = spec.reader("device_idle_share")(run)
    assert abs(idle - 70.0) < 1e-9
    share = spec.reader("ga_gen_step_roofline")(run)
    ms, _ = yardstick.bound(*yardstick.b2_bound(64, 40, 4, 1180, 5, 5, 4, 10))
    assert abs(share - ms / 1e3 / 200e-9 * 100) < 1e-9
    assert spec.reader("imc_eval_roofline")(run) is None  # no launch: nothing to read
    assert spec.reader("launches_per_search")(run) == 0.02
    assert spec.reader("host_bytes_per_search")(run) == 460.0
    assert spec.reader("latency_p95_ms.serve")(run) is None
