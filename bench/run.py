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

A cell whose ``chips`` is over 1 runs one process a card
(``bench/harness/ranks.py``): this process is rank 0 on ``cuda:0`` and
starts ranks 1 .. chips - 1 itself, each this script with ``--follower``
and ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and a free
``MASTER_PORT`` in its environment.  Only rank 0 prints the result;
``setup_s`` is its own, waiting for the other ranks and making the process
group included; ``memory_peak_bytes`` is the fullest card's; with
``--trace 1`` every card is traced over the same slice (``busy_s`` and
``window_s`` are the cards' mean, with collectives' kernels left out of
``busy_s``; the breakdown is rank 0's).  The other
ranks die with rank 0, and one that fails or exits early ends the run
within a second, with an exit code other than 0.  A cell on one card runs
in this process alone, as it always has.
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
    ap.add_argument("--follower", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    _environment()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench.harness import ranks
    from bench.harness.spec import Spec

    spec = Spec(ROOT)
    chips = int(spec.cell(args.workload)["chips"])
    if args.follower:
        _follower(args, spec)
    lead = None
    if chips > 1:  # the followers load while this process does
        lead = ranks.Lead(chips, [sys.executable, str(Path(__file__).resolve()),
                                  *(argv if argv is not None else sys.argv[1:]), "--follower"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: cell {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        if lead is not None:
            lead.kill()
        return 2
    from bench.harness.cell import report_checks, run_cell

    if lead is None:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                       t_start=T_START, device="cuda:0", chips=chips, spec=spec)
    else:
        try:
            rc, out = ranks.run_lead(lead, args.workload, args.seed, args.seconds,
                                     bool(args.trace), spec=spec, t_start=T_START)
        except Exception:  # noqa: BLE001 - reported; the followers go with this rank
            import traceback

            traceback.print_exc()
            lead.kill()
            rc = 1
        if rc:
            _exit_now(rc)
    code = 0
    bad = forbidden_modules()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        code = 3
    else:
        report_checks(out)
        print(json.dumps(out), flush=True)
    if lead is not None:
        _exit_now(code)
    return code


def _follower(args, spec) -> None:
    """A rank other than 0 of a cell on several cards; never returns."""
    import traceback

    from bench.harness import ranks

    try:
        code = ranks.follow(args.workload, args.seed, bool(args.trace), spec)
    except Exception:  # noqa: BLE001 - reported; the exit code ends the lead's run
        traceback.print_exc()
        code = 1
    bad = forbidden_modules()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        code = 3
    _exit_now(code)


def _exit_now(code: int) -> None:
    """Leave at once: a rank of a cell on several cards, once every rank has
    reported (``bench/harness/ranks.py``), tears no communicator down."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


if __name__ == "__main__":
    sys.exit(main())
