"""Roofline report and perf-iteration tool (the port's
``src/repro/launch/roofline.py``).

    python -m repro_torch.launch.roofline --report          # table from dry-run records
    python -m repro_torch.launch.roofline --hillclimb CELL  # re-trace a cell under a
                                                            # named variant set

Reads ``experiments/dryrun_torch/<mesh>/<cell>.json`` (written by
``launch/dryrun.py``; ``--dir`` another records directory) and prints the
roofline table, with the JAX report's columns plus each cell's FLOPs and
collective bytes per device and its trace seconds; the hillclimb mode
traces a cell on the fake single-pod mesh under named variants of its
``build_step`` and prints each one's terms.  ``--no-correction``, the JAX
tool's switch to skip its unrolled cost extrapolation, is accepted and
changes nothing: an eager trace counts every layer.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, List

from repro_torch.launch.dryrun import RESULT_DIR

DOC = __doc__

SINGLE_POD = "data=16xmodel=16"

HEADER = (
    "| cell | t_compute (ms) | t_memory (ms) | t_collective (ms) | bottleneck "
    "| mem/dev (GiB) | useful 6ND/FLOPs | roofline frac | FLOPs/dev | coll/dev (GB) "
    "| trace_s |\n"
    "|---|---|---|---|---|---|---|---|---|---|---|"
)


def load_records(mesh: str = SINGLE_POD, result_dir: Path = RESULT_DIR) -> List[Dict[str, Any]]:
    out = []
    d = Path(result_dir) / mesh
    if not d.exists():
        return out
    for p in sorted(d.glob("*.json")):
        if p.name.startswith("paper-dse"):
            continue
        with open(p) as f:
            out.append(json.load(f))
    return out


def row(rec: Dict[str, Any]) -> str:
    r = rec["roofline"]
    return (
        f"| {rec['cell']} | {r['t_compute_s']*1e3:.2f} | {r['t_memory_s']*1e3:.2f} "
        f"| {r['t_collective_s']*1e3:.2f} | {r['bottleneck']} "
        f"| {rec['memory']['per_device_gb']:.2f} | {r['useful_ratio']:.2f} "
        f"| {r['peak_fraction']:.1%} | {rec['cost']['flops_per_device']:.3e} "
        f"| {rec['collectives']['total_bytes'] / 1e9:.3f} | {rec['trace_s']:.1f} |"
    )


def report(mesh: str = SINGLE_POD, result_dir: Path = RESULT_DIR) -> str:
    return "\n".join([HEADER] + [row(r) for r in load_records(mesh, result_dir)])


# ------------------------------------------------------------------ hillclimb
VARIANTS: Dict[str, Dict[str, Any]] = {
    # name -> build_step kwargs overrides
    "baseline": {},
    "accum4": {"accum": 4},
    "accum8": {"accum": 8},
    "no-seq-parallel": {"sharding_overrides": {"seq": None}},
    "no-fsdp": {"sharding_overrides": {"embed": None}},
    "fsdp-2d": {"sharding_overrides": {"embed": ("data",)}},
    "seq-over-data": {"seq_axis": "data"},
    "cache-seq-2d": {"seq_axis": ("data", "model")},
    "no-remat": {"remat": False},
}


def hillclimb(cell_name: str, variants: List[str], device: str = "cuda", *,
              correct: bool = True):
    """Trace ``cell_name`` ("arch/shape") on the fake single-pod mesh once
    per variant; prints and returns [(variant, record)].  ``correct``
    (keyword-only, so ``device`` keeps its place) goes to ``dryrun_cell``,
    where it has no effect."""
    from repro_torch.configs.base import SHAPES_BY_NAME, get_config
    from repro_torch.launch.cells import Cell
    from repro_torch.launch.dryrun import dryrun_cell
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    arch, shape = cell_name.split("/")
    cell = Cell(get_config(arch), SHAPES_BY_NAME[shape])
    out = []
    with fake_world(256, device):
        mesh = make_production_mesh(device_type=device)
        for v in variants:
            try:
                rec = dryrun_cell(cell, mesh, save=False, build_kwargs=VARIANTS[v],
                                  device=device, correct=correct)
            except Exception as e:  # noqa: BLE001 - report the variant, try the next
                print(f"[{cell_name} :: {v}] FAIL {e!r}", flush=True)
                continue
            r = rec["roofline"]
            print(f"[{cell_name} :: {v}] comp={r['t_compute_s']*1e3:.2f}ms "
                  f"mem={r['t_memory_s']*1e3:.2f}ms coll={r['t_collective_s']*1e3:.2f}ms "
                  f"bottleneck={r['bottleneck']} "
                  f"mem/dev={rec['memory']['per_device_gb']:.2f}GiB", flush=True)
            out.append((v, rec))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=DOC,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--mesh", default=SINGLE_POD)
    ap.add_argument("--dir", default=str(RESULT_DIR), help="records directory")
    ap.add_argument("--hillclimb", default=None, help="arch/shape cell name")
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--device", default="cuda",
                    help="device the hillclimb's fake tensors claim ('cpu' without CUDA)")
    ap.add_argument("--no-correction", action="store_true",
                    help="the JAX tool's switch to skip its unrolled cost extrapolation; "
                         "no effect here")
    args = ap.parse_args(argv)

    if args.report:
        print(report(args.mesh, Path(args.dir)))
        return 0
    if args.hillclimb:
        hillclimb(args.hillclimb, args.variants.split(","), correct=not args.no_correction,
                  device=args.device)
        return 0
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
