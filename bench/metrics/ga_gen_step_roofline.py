"""Share (%) of its roofline that kernel B2 (``ga_gen_step``) reaches in the
traced slice: the least time of each launch, from its shapes by the frozen
``b2_bound`` (``bench/harness/yardstick.py``), summed, over the device time
of its ``ga_gen_step_kernel`` activities."""
from bench.harness import yardstick


def read(run):
    bound_s = dev_s = 0.0
    for t in run.traces:
        for x in t.launches:
            if x.op != "repro_torch::ga_gen_step":
                continue
            (B, P, _), (_, tot) = x.shapes[0], x.shapes[2]
            _, W, R, C, Bc = x.shapes[3]
            Gn = x.shapes[5][2]
            ms, _ = yardstick.bound(*yardstick.b2_bound(B, P, W, tot, R, C, Bc, Gn))
            bound_s += ms / 1e3
            dev_s += x.device_s
    return bound_s / dev_s * 100.0 if dev_s > 0 else None
