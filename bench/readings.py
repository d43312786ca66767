#!/usr/bin/env python3
"""The readings the correctness limits are set from, for one cell, in one
process on the card: the program's numbers on each of ``--seeds``, the
bfloat16 control's on the first ``--control-seeds`` of them (the same
answers, re-scored in bfloat16), and each fault of ``--faults``
(``bench/harness/faults.py``) on ``--fault-seeds`` further seeds.

    python3 bench/readings.py --workload cnn4-serve-table --seeds 1,2,3 \\
        --seconds 20 --control-seeds 3 --faults frozen_step --fault-seeds 3

Prints one JSON line a run, then the summary: the largest program reading
and the smallest control and fault readings of each number.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--fault-seconds", type=float, default=None)
    ap.add_argument("--device", default="cuda:0", help="cpu: a rehearsal off the card")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench.run import _environment

    _environment()
    from bench.harness import check
    from bench.harness.cell import run_cell
    from bench.harness.faults import FAULTS
    from bench.harness.spec import Spec

    spec = Spec(ROOT)
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = {"program": {}, "control": {}}

    def note(mode, seed, numbers, rate, worst):
        print(json.dumps({"mode": mode, "seed": seed, "searches_per_s": rate,
                          **{k: numbers[k] for k in check.NAMES}}), flush=True)
        agg = summary.setdefault(mode, {})
        for k in check.NAMES:
            agg[k] = numbers[k] if k not in agg else worst(agg[k], numbers[k])

    for i, seed in enumerate(seeds):
        out = run_cell(args.workload, seed, args.seconds, False, t_start=time.perf_counter(),
                       device=args.device, spec=spec, control=i < args.control_seeds)
        rate = out["metrics"]["searches_per_s"]["value"]
        note("program", seed, {k: v["value"] for k, v in out["checks"].items()}, rate, max)
        if "control" in out:
            note("control", seed, out["control"], rate, min)
    fault_seed = max(seeds) + 1
    for name in filter(None, args.faults.split(",")):
        for j in range(args.fault_seeds):
            with FAULTS[name]():
                out = run_cell(args.workload, fault_seed + j, args.fault_seconds or args.seconds,
                               False, t_start=time.perf_counter(), device=args.device, spec=spec)
            note(name, fault_seed + j, {k: v["value"] for k, v in out["checks"].items()},
                 out["metrics"]["searches_per_s"]["value"], min)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
