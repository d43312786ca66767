"""Beyond the paper: one IMC chip for an LLM serving mix, on the port.

The counterpart of ``examples/lm_hw_cosearch.py``: the workload set is a
mix of LM architectures in decode mode (token-at-a-time serving), exported
as IMC layers from their configs (``workloads/lm.py``), and the joint
search finds one chip that serves all of them; per-model searches from the
same population are then re-scored on the whole mix.

    PYTHONPATH=src python -m repro_torch.examples.lm_hw_cosearch --device cpu

LM decode workloads are weight-capacity bound: only the top corner of the
grid fits (a few of its 12,000 capacity cells), so the population is seeded
with deep oversampling, and the area budget is a multi-chiplet system's
(12,000 mm^2), not the paper's single chip.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core.search import (
    joint_search,
    rescore_designs,
    seed_population,
    separate_search,
)
from repro_torch.device import resolve_device
from repro_torch.workloads.lm import lm_workload
from repro_torch.workloads.pack import pack_workloads

ARCHS = ("llama3.2-1b", "qwen2-vl-2b", "mamba2-780m")
AREA = 12_000.0
SEED = 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--backend", default="table", choices=["dense", "kernel", "table"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pop", type=int, default=40)
    ap.add_argument("--gens", type=int, default=10)
    ap.add_argument("--out", default="", help="JSON of each search's best design")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    named = [(a, lm_workload(get_config(a), mode="decode")) for a in ARCHS]
    ws = pack_workloads(named)
    print(f"LM serving mix: {ws.names} ({[len(l) for _, l in named]} IMC layers each)")
    kw = dict(area_constr=AREA, pop_size=args.pop, generations=args.gens,
              backend=args.backend, device=dev)
    t0 = time.perf_counter()
    init = seed_population(SEED, ws, args.pop, oversample=1024, max_rounds=32,
                           device=dev)
    res = joint_search(SEED, ws, init_genomes=init, **kw)
    if not len(res.top_scores):
        print("joint search: no feasible design")
        return 1
    print(f"\njoint LM-serving chip ({time.perf_counter() - t0:.1f}s), "
          f"score {res.top_scores[0]:.4g}:")
    for k, v in res.top_designs[0].items():
        print(f"   {k:14s} = {v}")

    sep = separate_search(SEED + 1, ws, share_init=init, **kw)
    if args.out:
        def best(r):
            return {"best": float(r.top_scores[0]) if len(r.top_scores) else None,
                    "design": r.top_designs[0] if r.top_designs else None}

        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"joint": best(res), "separate": {n: best(r) for n, r in sep.items()}}, indent=1))
    print("\nper-model chips re-scored on the full mix:")
    for name, r in sep.items():
        if not len(r.top_genomes):
            print(f"   {name:14s}: no feasible designs")
            continue
        s_all, _ = rescore_designs(r.top_genomes, ws, area_constr=AREA, device=dev)
        fin = s_all[np.isfinite(s_all)]
        best = f"{fin.min():.4g}" if len(fin) else "none"
        print(f"   {name:14s}: {np.mean(~np.isfinite(s_all)):4.0%} fail on the mix; "
              f"best surviving score {best} (joint: {res.top_scores[0]:.4g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
