#!/usr/bin/env python3
"""The readings the correctness limits are set from, for one cell, in one
process on the card: the program's numbers on each of ``--seeds``, the
bfloat16 control's on the first ``--control-seeds`` of them (the same
answers, re-scored in bfloat16), and each fault of ``--faults``
(``bench/harness/faults.py``) on ``--fault-seeds`` further seeds.

    python3 bench/readings.py --workload cnn4-serve-table --seeds 1,2,3 \\
        --seconds 20 --control-seeds 3 --faults frozen_step --fault-seeds 3

Prints one JSON line a run, then the summary: the largest program reading
and the smallest control and fault readings of each number.  A cell on
several cards runs each reading in processes of its own, one a rank
(``ranks.run_lead`` and ``ranks.follow``, as ``bench/run.py`` runs them),
with the fault planted on every rank; a run that ends with no result is
printed with its exit code and left out of the summary.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the ranks of a reading on several cards, each its own process; each
# leaves with os._exit, as bench/run.py's do, once every rank has reported
PRELUDE = """
import json, os, sys, time, traceback
T_START = time.perf_counter()
sys.path[:0] = [{src!r}, {root!r}]
from bench.harness import ranks
from bench.harness.spec import Spec
"""
FOLLOWER = PRELUDE + """
try:
    rc = ranks.follow({cell!r}, {seed}, False, Spec({root!r}), device_type={device_type!r})
except Exception:
    traceback.print_exc()
    rc = 1
sys.stdout.flush()
sys.stderr.flush()
os._exit(rc)
"""
LEAD = PRELUDE + """
from bench.run import _environment
_environment()
lead = ranks.Lead({chips}, [sys.executable, "-c", {follower!r}])
try:
    rc, out = ranks.run_lead(lead, {cell!r}, {seed}, {seconds}, False, spec=Spec({root!r}),
                             t_start=T_START, device_type={device_type!r}, fault={fault!r},
                             control={control})
except Exception:
    traceback.print_exc()
    lead.kill()
    rc, out = 1, None
if out is not None:
    print(json.dumps(out), flush=True)
sys.stderr.flush()
os._exit(rc)
"""


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
    from bench.harness import ranks
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

    chips = int(spec.cell(args.workload)["chips"])

    def run(seed, seconds, control=False, fault=""):
        if chips == 1:
            with ranks.planted(fault):
                return run_cell(args.workload, seed, seconds, False,
                                t_start=time.perf_counter(), device=args.device, spec=spec,
                                control=control)
        kw = dict(src=str(ROOT / "src"), root=str(ROOT), cell=args.workload, seed=seed,
                  device_type=args.device.split(":")[0])
        code = LEAD.format(chips=chips, follower=FOLLOWER.format(**kw), seconds=seconds,
                           fault=fault, control=control, **kw)
        try:
            p = subprocess.run([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
                               timeout=360)
            rc = p.returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        if rc:
            print(json.dumps({"mode": fault or "program", "seed": seed, "rc": rc}), flush=True)
            return None
        return json.loads(p.stdout.strip().splitlines()[-1])

    for i, seed in enumerate(seeds):
        out = run(seed, args.seconds, control=i < args.control_seeds)
        if out is None:
            continue
        rate = out["metrics"]["searches_per_s"]["value"]
        note("program", seed, {k: v["value"] for k, v in out["checks"].items()}, rate, max)
        if "control" in out:
            note("control", seed, out["control"], rate, min)
    fault_seed = max(seeds) + 1
    for name in filter(None, args.faults.split(",")):
        for j in range(args.fault_seeds):
            out = run(fault_seed + j, args.fault_seconds or args.seconds, fault=name)
            if out is not None:
                note(name, fault_seed + j, {k: v["value"] for k, v in out["checks"].items()},
                     out["metrics"]["searches_per_s"]["value"], min)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
