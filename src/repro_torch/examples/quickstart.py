"""Quickstart: the paper in a few lines (the counterpart of
``examples/quickstart.py``).

Runs the joint hardware-workload search over the paper's four CNN
workloads from ``PRNGKey(0)``, prints the best generalized IMC design, and
contrasts it with the separate per-workload searches from ``PRNGKey(1)``,
most of whose winners fail on the other workloads (the paper's headline
result).  Both run on the threefry streams, so they draw what the JAX
package's quickstart draws.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu --pop 8 --gens 2 \
        --area 1e9
"""
import argparse
import sys
import time

import numpy as np

from repro_torch.core.search import joint_search, rescore_designs, separate_search
from repro_torch.device import resolve_device
from repro_torch.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro_torch.workloads.pack import pack_workloads


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--pop", type=int, default=40)
    ap.add_argument("--gens", type=int, default=10)
    ap.add_argument("--area", type=float, default=150.0, help="area constraint, mm^2")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kw = dict(pop_size=args.pop, generations=args.gens, area_constr=args.area, device=dev,
              prng="threefry")

    ws = pack_workloads([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])
    print(f"workloads: {ws.names}")

    t0 = time.perf_counter()
    res = joint_search(0, ws, **kw)
    dt = time.perf_counter() - t0
    print(f"\njoint search: {args.pop * (args.gens + 1)} designs evaluated in "
          f"{dt:.2f}s on {dev} (host clock, first call included)")
    if not res.top_designs:
        print("no feasible design found")
        return 1
    print(f"best generalized design (score {res.top_scores[0]:.6g}):")
    for k, v in res.top_designs[0].items():
        print(f"   {k:14s} = {v}")

    sep = separate_search(1, ws, **kw)
    print("\nseparate searches, re-scored on ALL workloads:")
    for name, r in sep.items():
        s_all = (rescore_designs(r.top_genomes, ws, area_constr=args.area, device=dev)[0]
                 if len(r.top_genomes) else [])
        failed = float(np.mean(~np.isfinite(s_all))) if len(s_all) else 1.0
        print(f"   optimized for {name:12s}: {failed:4.0%} of top designs "
              f"fail on the full workload set")
    return 0


if __name__ == "__main__":
    sys.exit(main())
