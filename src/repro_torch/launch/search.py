"""Paper driver: joint hardware-workload search CLI on the port.

    PYTHONPATH=src python -m repro_torch.launch.search \
        --workloads vgg16,resnet18,alexnet,mobilenetv3 \
        --objective ela --area 150 --pop 40 --gens 10 --seeds 8 --separate \
        --backend table

Joint search (the paper's method) over the workload set, one GA per
seed, all seeds as one batched GA; with ``--separate`` also the
per-workload baselines, whose winners are re-scored on the whole set.
``--backend`` picks the evaluator: ``dense`` (plain PyTorch cost model),
``kernel`` (its layer sums from the ``imc_eval`` CUDA kernel) or
``table`` (factorized grid tables; every generation on the card is one
``ga_gen_step`` kernel launch).  ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.search import (
    joint_search_batched,
    rescore_designs,
    separate_search,
)
from repro_torch.core.objectives import OBJECTIVES
from repro_torch.device import resolve_device
from repro_torch.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro_torch.workloads.pack import WorkloadSet, pack_workloads


def build_workloads(args) -> WorkloadSet:
    names = [n for n in args.workloads.split(",") if n] or list(PAPER_WORKLOADS)
    return pack_workloads([(n, cnn_workload(n)) for n in names])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", default="", help="CNN names, comma-sep")
    ap.add_argument("--objective", default="ela", choices=list(OBJECTIVES))
    ap.add_argument(
        "--backend", default="dense", choices=["dense", "kernel", "table"],
        help="cost-model evaluator: plain PyTorch, the imc_eval kernel, or "
             "per-workload grid tables (generations through ga_gen_step)",
    )
    ap.add_argument("--area", type=float, default=150.0)
    ap.add_argument("--pop", type=int, default=40)
    ap.add_argument("--gens", type=int, default=10)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--separate", action="store_true",
                    help="also run per-workload baselines")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    if args.seeds < 1:
        ap.error("--seeds must be >= 1")
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ws = build_workloads(args)
    print(f"[search] workloads: {ws.names} (L_max={ws.feats.shape[1]}) "
          f"on {dev} ({name})")

    kw = dict(objective=args.objective, area_constr=args.area,
              pop_size=args.pop, generations=args.gens,
              backend=args.backend, device=dev)
    t0 = time.perf_counter()
    ress = joint_search_batched(list(range(args.seeds)), ws, **kw)
    dt_all = time.perf_counter() - t0
    n_evald = args.seeds * args.pop * (args.gens + 1)
    print(f"[search] {args.seeds} seed(s) in {dt_all:.3f}s "
          f"({n_evald / dt_all:.0f} designs/s on {name}, host clock, "
          f"first call included)")

    results = []
    for seed, res in enumerate(ress):
        best = f"{res.top_scores[0]:.4g}" if len(res.top_scores) else "infeasible"
        print(f"[search] seed {seed}: best={best}")
        if res.top_designs:
            print(f"         best design: {res.top_designs[0]}")
        entry = {
            "seed": seed,
            "joint_best": float(res.top_scores[0]) if len(res.top_scores) else None,
            "joint_top10": [float(s) for s in res.top_scores],
            "best_design": res.top_designs[0] if res.top_designs else None,
            "convergence": [float(c) for c in res.convergence],
            "wall_s": dt_all / args.seeds,
        }
        if args.separate:
            sep = separate_search(seed + 1000, ws, **kw)
            cross = {}
            for wname, r in sep.items():
                best_on_all = None
                if len(r.top_genomes):
                    s_all, _ = rescore_designs(
                        r.top_genomes, ws, objective=args.objective,
                        area_constr=args.area, device=dev)
                    failed = float(np.mean(~np.isfinite(s_all)))
                    fin = s_all[np.isfinite(s_all)]
                    best_on_all = float(fin.min()) if len(fin) else None
                else:
                    failed = 1.0
                cross[wname] = {
                    "own_best": float(r.top_scores[0]) if len(r.top_scores) else None,
                    "best_design": r.top_designs[0] if r.top_designs else None,
                    "failed_frac_on_all": failed,
                    "best_on_all": best_on_all,
                }
            entry["separate"] = cross
            print(f"         separate: {json.dumps(cross)}")
        results.append(entry)

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[search] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
