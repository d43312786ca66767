#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port and print its
result as the last line of standard output (one JSON object).

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration and traffic
mix; ``bench/harness`` runs it.  With ``--trace 0`` the line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.  The
numbers that decide ``correct`` are printed beside their limits as the last
lines of standard error and under ``checks`` in the line.  Without enough
CUDA cards, or if JAX or the JAX package got loaded, it prints no result and
exits with a code other than 0.  Builds and caches stay in ``build/`` of the
checkout; PyTorch runs one host thread.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _environment() -> None:
    """Builds and caches inside the checkout, at fixed paths; one CPU
    thread for PyTorch's and the BLAS's operations on the host, so that
    they do not contend with the search's and the service's threads (a
    service run read 2,067-2,812 searches/s with it against 2,024-2,263
    without, on an H100 machine of 8 cores)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    cache = ROOT / "build" / "bench-cache"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch_kernels")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _environment()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench.harness.spec import Spec

    spec = Spec(ROOT)
    chips = int(spec.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: cell {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from bench.harness.cell import report_checks, run_cell

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START, device="cuda:0", chips=chips, spec=spec)
    bad = forbidden_modules()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    report_checks(out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
