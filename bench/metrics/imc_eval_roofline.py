"""Share (%) of its roofline that kernel B1 (``imc_eval``) reaches in the
traced slice: the least time of each launch, from its shapes by the frozen
byte and operation count (``bench/harness/yardstick.py``), summed, over the
device time of its ``imc_eval_kernel`` activities.  A launch whose layer
count the cell does not know is left out."""
from bench.harness import yardstick


def read(run):
    bound_s = dev_s = 0.0
    for t in run.traces:
        for x in t.launches:
            if x.op != "repro_torch::imc_eval":
                continue
            (B, P, _), (_, W, L, _) = x.shapes[0], x.shapes[1]
            layers = run.b1_layers.get((B, W, L))
            if layers is None:
                continue
            ms, _ = yardstick.bound(*yardstick.b1_bound(B, P, W, L, layers))
            bound_s += ms / 1e3
            dev_s += x.device_s
    return bound_s / dev_s * 100.0 if dev_s > 0 else None
