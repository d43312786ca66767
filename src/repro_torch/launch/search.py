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

``--objective pareto`` runs NSGA-II front search: each seed's result holds
the ``--pareto-k`` best front members in crowded order with their (E, L,
A) vectors (with ``--separate``, the winners are re-scored on the whole set
under the scalar proxy E*L*A, the ``ela`` objective).

``--prng threefry`` draws every search's randomness as the JAX package
does: the joint seeds ``s`` are ``PRNGKey(s)``, the separate searches of
seed ``s`` split ``PRNGKey(s + 1000)``, and ``--serve`` request i draws
from ``PRNGKey(i)``, so a run replays the JAX CLI's run with the same
flags.  The default, ``--prng torch``, draws from ``torch.Generator``s.

``--lm-workloads`` adds LM architectures (``configs``) exported as IMC
workloads (``workloads/lm.py``, ``--mode decode|prefill``, ``--seq`` tokens
for prefill) to the CNNs of ``--workloads``.  LM weights fill all but a few
of the grid's capacity cells, so the rejection seeder rarely finds a
population for them, and the CLI then stops with "could not seed", as the
JAX package's does (``--lm-workloads llama3.2-1b,mixtral-8x7b --mode
decode`` stops there in both).  Seed such mixes through the API, with
``SearchEngine(direct_seed=True)`` on the table backend or by deep
oversampling, as ``src/repro_torch/examples/lm_hw_cosearch.py`` does.

``--serve N`` runs the DSE service instead: N heterogeneous requests
(workload subsets x objectives x seeds over the selected set,
``serve.dse.paper_request_mix``) are queued and drained, slot-packed,
through one ``SearchEngine``; each request's best prints as its launch
lands, then a requests/s and latency-percentile summary:

    PYTHONPATH=src python -m repro_torch.launch.search --serve 256 --backend table

``--serve-policy priority|edf`` schedules by request priority (mixed
priorities are cycled into the mix) or earliest deadline, and
``--serve-async`` drains through the threaded ``AsyncDSEService``.
``--pipelined`` runs the thin path (the top designs are picked on the
device; only they and the convergence curve come back) and, under
``--serve``, dispatches plan i+1 before harvesting plan i.
``--segment-gens K`` runs every search as segments of K generations (the
same bits) with a NaN guard and ``--segment-retries``;
``--checkpoint-dir DIR`` saves segment boundaries, so a killed run
resumes.  ``--retry-attempts`` / ``--retry-backoff`` arm the service's
retry lane, ``--partial-results`` resolves quarantined or late requests
with their best so far, ``--result-cache DIR`` answers requests seen
before (this process or an earlier one over DIR, on the same device)
with no launch, and ``--stream-progress`` prints each request's best so
far after every segment.

``--search-mesh SxP`` runs the search (and ``--serve``) on a (search,
population) mesh of ranks, one process per card: S splits the independent
GAs (seeds, workloads, requests), P each population (``core.distributed``),
sizes clamped to the world as the JAX CLI clamps them to its devices.
Start one process per rank with ``torchrun``; without torchrun's variables
the world is one rank.  Rank 0 prints and writes ``--out``; every result
is bit for bit the meshless run's:

    torchrun --nproc-per-node 8 -m repro_torch.launch.search --search-mesh 8x1
    torchrun --nproc-per-node 2 -m repro_torch.launch.search --device cpu \
        --search-mesh 2x1 --pop 16 --gens 3 --seeds 4

The process groups run NCCL on the card (one card per rank) and gloo on
the CPU.

``--profile PATH`` runs the searches (or the ``--serve`` drain) under
``torch.profiler`` (CPU and CUDA, every thread where this torch allows
it), writes its Chrome trace to PATH and prints the program's spans
(``repro_torch.spans``): for each, its count and total and self ms.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import spans
from repro_torch.configs.base import get_config
from repro_torch.core.engine import SearchEngine
from repro_torch.core.search import (
    joint_search_batched,
    rescore_designs,
    separate_search,
)
from repro_torch.core.objectives import OBJECTIVES, PARETO
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import describe, init_world, make_search_mesh
from repro_torch.serve.cache import ResultCache
from repro_torch.serve.dse import AsyncDSEService, DSEService, RetryPolicy, paper_request_mix
from repro_torch.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro_torch.workloads.lm import lm_workload
from repro_torch.workloads.pack import WorkloadSet, pack_workloads


def build_workloads(args) -> WorkloadSet:
    """The CNNs of ``--workloads`` and the LM configs of ``--lm-workloads``;
    the paper's four CNNs when both are empty."""
    named = [(n, cnn_workload(n)) for n in args.workloads.split(",") if n]
    named += [(n, lm_workload(get_config(n), mode=args.mode, seq=args.seq))
              for n in args.lm_workloads.split(",") if n]
    return pack_workloads(named or [(n, cnn_workload(n)) for n in PAPER_WORKLOADS])


def _fmt(v, spec: str = ".2f") -> str:
    """A possibly-``None`` percentile (empty sample window)."""
    return "n/a" if v is None else f"{v:{spec}}"


def _quiet(*args, **kw) -> None:
    """``print`` on a rank other than the first."""


def span_table(snap) -> str:
    """``spans.snapshot()`` as a table, the longest total first."""
    rows = [f"{'span':<32}{'count':>8}{'total ms':>12}{'self ms':>12}"]
    for name, v in sorted(snap.items(), key=lambda kv: -kv[1]["total_s"]):
        rows.append(f"{spans.PREFIX + name:<32}{v['count']:>8}"
                    f"{v['total_s'] * 1e3:>12.3f}{v['self_s'] * 1e3:>12.3f}")
    return "\n".join(rows)


@contextlib.contextmanager
def profiled(path: str, dev, log=print):
    """``--profile PATH``: the body under ``torch.profiler`` (CPU, and
    CUDA on a card; host events on every thread where this torch has the
    option), its Chrome trace written to PATH and the span table printed.
    Without PATH the body runs as it is."""
    if not path:
        yield
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    try:
        every_thread = _ExperimentalConfig(profile_all_threads=True)
    except TypeError:
        every_thread = None
    cuda = dev.type == "cuda"
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []),
                 experimental_config=every_thread) as prof:
        yield
        if cuda:
            torch.cuda.synchronize(dev)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(path)
    log(f"[profile] wrote {path}\n{span_table(spans.snapshot())}")


def build_engine(args, dev, result_cache=None, mesh=None):
    """A ``SearchEngine`` with the knobs when one is set, else ``None``
    (the search functions then use the shared engine with ``mesh=`` per
    call; the service builds its own around ``result_cache``)."""
    if not (args.segment_gens or args.checkpoint_dir or args.pipelined):
        return None
    # checkpoints are written at segment boundaries: a checkpoint dir
    # without a segment length gets 1-generation segments
    return SearchEngine(
        device=dev,
        segment_gens=args.segment_gens or (1 if args.checkpoint_dir else None),
        segment_retries=args.segment_retries,
        checkpoint_dir=args.checkpoint_dir or None,
        result_cache=result_cache,
        pipelined=args.pipelined,
        prng=args.prng,
        mesh=mesh,
    )


def _best(res) -> str:
    return f"{res.top_scores[0]:.4g}" if len(res.top_scores) else "infeasible"


def serve(args, ws: WorkloadSet, dev, mesh=None, log=print) -> int:
    """``--serve N``: drain N mixed requests through the DSE service (on
    ``mesh``, the first rank plans and the others follow)."""
    cache = None
    if args.result_cache:
        cache = ResultCache(disk_dir=args.result_cache, device=dev, prng=args.prng)
        log(f"[serve] result cache armed ({len(cache.disk_keys())} "
              f"entries on disk under {args.result_cache})")
    if args.stream_progress and not (args.segment_gens or args.checkpoint_dir):
        # streaming needs segment boundaries; segments change no result
        args.segment_gens = 2
        log("[serve] --stream-progress: defaulting --segment-gens 2")
    engine = build_engine(args, dev, result_cache=cache, mesh=mesh)
    on_progress = None
    if args.stream_progress:
        def on_progress(rid, snap):
            log(f"[serve] rid {rid} partial @gen {snap.generations}: "
                  f"best-so-far {_best(snap)}")
    retry = None
    if args.retry_attempts > 1:
        retry = RetryPolicy(max_attempts=args.retry_attempts,
                            backoff_s=args.retry_backoff)
    svc_kw = dict(engine=engine, device=dev, policy=args.serve_policy,
                  retry=retry, partial_results=args.partial_results,
                  result_cache=cache, pipelined=args.pipelined or None,
                  prng=args.prng, mesh=mesh)
    mix_kw = {}
    if args.serve_policy == "priority":
        mix_kw["priorities"] = [3, 0, 1, 2]
    elif args.serve_policy == "edf":
        mix_kw["deadlines_s"] = [5.0, 60.0, 30.0, None]
    reqs = paper_request_mix(ws, args.serve, backend=args.backend, pop_size=args.pop,
                             generations=args.gens, area_constr=args.area, **mix_kw)
    results = {}
    t0 = time.perf_counter()
    if args.serve_async:
        with AsyncDSEService(**svc_kw) as svc:
            futs = [svc.submit(r, on_progress=on_progress) for r in reqs]
            log(f"[serve] {args.serve} heterogeneous requests submitted "
                  f"async (policy={args.serve_policy}, backend={args.backend}, "
                  f"slots={svc.service.engine.max_slots})")
            for fut in futs:
                res = results[fut.rid] = fut.result()
                log(f"[serve] rid {fut.rid}: {res.objective} on "
                      f"{','.join(res.workload_names)} -> best={_best(res)}")
        stats, eng = svc.stats, svc.service.engine
    else:
        svc = DSEService(**svc_kw)
        rids = [svc.submit(r, on_progress=on_progress) for r in reqs]
        log(f"[serve] {args.serve} heterogeneous requests queued "
              f"(policy={args.serve_policy}, backend={args.backend}, "
              f"slots={svc.engine.max_slots})")
        # cache hits resolved at submit never reach the queue
        for rid in rids:
            res = svc.results.get(rid)
            if res is not None:
                results[rid] = res
                log(f"[serve] rid {rid}: {res.objective} on "
                      f"{','.join(res.workload_names)} -> best={_best(res)} "
                      f"(cache hit)")
        for rid, res in svc.stream():
            results[rid] = res
            log(f"[serve] rid {rid}: {res.objective} on "
                  f"{','.join(res.workload_names)} -> best={_best(res)}")
        stats, eng = svc.stats, svc.engine
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_evald = args.serve * args.pop * (args.gens + 1)
    log(f"[serve] drained {len(results)} requests in {dt:.1f}s "
          f"({len(results) / dt:.1f} req/s, {n_evald / dt:.0f} designs/s, "
          f"{stats.launches} launches, wait p50/p99 "
          f"{_fmt(stats.wait_p(50))}/{_fmt(stats.wait_p(99))}s, "
          f"latency p50/p99 {_fmt(stats.latency_p(50))}/"
          f"{_fmt(stats.latency_p(99))}s, "
          f"{stats.deadline_misses} deadline misses)")
    log(f"[serve] faults: {stats.failures} failures, {stats.retries} "
          f"retries, {stats.partials} partials, {stats.abandoned} abandoned")
    log(f"[serve] overlap: pipelined={'on' if args.pipelined else 'off'}, "
          f"dispatch->harvest gap p50 "
          f"{_fmt(stats.dispatch_gap_p(50), '.4f')}s, no launch in flight "
          f"(host estimate) {stats.device_idle_s:.3f}s, "
          f"{getattr(eng, 'transfer_bytes', 0)} bytes harvested over "
          f"{getattr(eng, 'launches', 0)} engine launches")
    if cache is not None:
        log(f"[serve] cache: {stats.cache_hits} submit hits / "
              f"{stats.cache_misses} misses this drain "
              f"(hit rate {stats.cache_hit_rate():.1%}); tiers: "
              f"{cache.stats.summary()}")
    if args.out and log is not _quiet:
        payload = [
            {
                "rid": rid,
                "objective": res.objective,
                "workloads": list(res.workload_names),
                "best": float(res.top_scores[0]) if len(res.top_scores) else None,
                "best_design": res.top_designs[0] if res.top_designs else None,
                "top_scores": [float(v) for v in res.top_scores],
            }
            for rid, res in sorted(results.items())
        ]
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        log(f"[serve] wrote {args.out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", default="", help="CNN names, comma-sep")
    ap.add_argument("--lm-workloads", default="",
                    help="LM config names (configs/), comma-sep, as IMC workloads")
    ap.add_argument("--mode", default="decode", choices=["decode", "prefill"],
                    help="--lm-workloads: per-token decode or a whole prefill")
    ap.add_argument("--seq", type=int, default=256,
                    help="--lm-workloads --mode prefill: tokens per prefill")
    ap.add_argument(
        "--objective", default="ela", choices=list(OBJECTIVES) + [PARETO],
        help="scalar objective (ela/edp/e/l) or 'pareto' for NSGA-II front "
             "search: each result holds the --pareto-k best non-dominated "
             "designs in crowded order with their (E, L, A) vectors")
    ap.add_argument("--pareto-k", type=int, default=10, metavar="K",
                    help="--objective pareto: front members to return")
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
    ap.add_argument(
        "--prng", default="torch", choices=["torch", "threefry"],
        help="random streams: torch.Generators, or the JAX package's threefry "
             "streams (a seed draws what the JAX CLI draws from it)")
    ap.add_argument(
        "--serve", type=int, default=0, metavar="N",
        help="run the DSE service on N heterogeneous requests (mixed "
             "workload subsets / objectives / seeds) instead of the search",
    )
    ap.add_argument(
        "--serve-policy", default="fifo", choices=["fifo", "priority", "edf"],
        help="--serve scheduling policy; priority/edf cycle mixed "
             "priorities / deadlines into the request mix",
    )
    ap.add_argument("--serve-async", action="store_true",
                    help="drain --serve through the threaded AsyncDSEService")
    ap.add_argument(
        "--pipelined", action="store_true",
        help="thin path: the top designs are picked on the device and only "
             "they come back (result.ga is None); under --serve, dispatch "
             "plan i+1 before harvesting plan i; the same results",
    )
    ap.add_argument(
        "--segment-gens", type=int, default=0, metavar="K",
        help="run each search as segments of K generations (the same bits) "
             "with a NaN guard; 0 = one launch",
    )
    ap.add_argument("--segment-retries", type=int, default=1,
                    help="retries of a failed segment from the last good state")
    ap.add_argument(
        "--checkpoint-dir", default="", metavar="DIR",
        help="save segment boundaries under DIR; the same plan run again "
             "resumes (1-generation segments unless --segment-gens is set)",
    )
    ap.add_argument(
        "--retry-attempts", type=int, default=0, metavar="N",
        help="--serve: launch attempts per request before it is abandoned "
             "(failed chunks re-plan each member alone); <2 disables retries",
    )
    ap.add_argument("--retry-backoff", type=float, default=0.5, metavar="S",
                    help="--serve: base retry backoff in seconds")
    ap.add_argument(
        "--partial-results", action="store_true",
        help="--serve: resolve quarantined / past-deadline requests with "
             "their best so far (partial=True) instead of dropping them",
    )
    ap.add_argument(
        "--result-cache", default="", metavar="DIR",
        help="--serve: result cache with a disk tier under DIR; a request "
             "answered before on this device resolves with no launch",
    )
    ap.add_argument(
        "--stream-progress", action="store_true",
        help="--serve: print each request's best so far after every "
             "segment (--segment-gens 2 unless a boundary is set)",
    )
    ap.add_argument(
        "--search-mesh", default="", metavar="SxP",
        help="(search, population) mesh of ranks, e.g. 8x1: split the "
             "searches over S ranks and each population over P (one process "
             "per rank, torchrun; sizes clamp to the world)")
    ap.add_argument("--out", default="")
    ap.add_argument(
        "--profile", default="", metavar="PATH",
        help="run under torch.profiler (on a mesh, the first rank): write its "
             "Chrome trace to PATH and print each span's count and total and "
             "self ms")
    args = ap.parse_args(argv)

    if args.seeds < 1:
        ap.error("--seeds must be >= 1")
    log = print
    mesh = None
    if args.search_mesh:
        try:
            s, p = (int(v) for v in args.search_mesh.lower().split("x"))
        except ValueError:
            ap.error(f"--search-mesh takes SxP, got {args.search_mesh!r}")
        rank, world, dev = init_world(args.device)
        mesh = make_search_mesh(s, p, device_type=dev.type)
        if mesh is None:
            print(f"[search] rank {rank} idle: the {s}x{p} mesh clamps to fewer "
                  f"ranks than the world of {world}")
            return 0
        if rank:
            log = _quiet  # the first rank alone reports
        log(f"[search] mesh: {describe(mesh)} ({world} ranks, "
              f"{torch.distributed.get_backend()})")
    else:
        dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ws = build_workloads(args)
    log(f"[search] workloads: {ws.names} (L_max={ws.feats.shape[1]}) "
          f"on {dev} ({name})")
    profile = args.profile if log is not _quiet else ""  # the first rank's
    if args.serve:
        with profiled(profile, dev, log):
            return serve(args, ws, dev, mesh, log)

    kw = dict(objective=args.objective, area_constr=args.area,
              pop_size=args.pop, generations=args.gens, pareto_k=args.pareto_k,
              backend=args.backend, device=dev, engine=build_engine(args, dev, mesh=mesh),
              prng=args.prng, mesh=mesh)
    # separate winners are re-scored on the whole set under a scalar
    # objective: the Pareto family's is its E*L*A proxy, the ela objective
    rescore_obj = "ela" if args.objective == PARETO else args.objective
    with profiled(profile, dev, log):
        t0 = time.perf_counter()
        ress = joint_search_batched(list(range(args.seeds)), ws, **kw)
        dt_all = time.perf_counter() - t0
        n_evald = args.seeds * args.pop * (args.gens + 1)
        log(f"[search] {args.seeds} seed(s) in {dt_all:.3f}s "
              f"({n_evald / dt_all:.0f} designs/s on {name}, host clock, "
              f"first call included)")

        results = []
        for seed, res in enumerate(ress):
            best = f"{res.top_scores[0]:.4g}" if len(res.top_scores) else "infeasible"
            log(f"[search] seed {seed}: best={best}")
            if res.top_designs:
                log(f"         best design: {res.top_designs[0]}")
            entry = {
                "seed": seed,
                "joint_best": float(res.top_scores[0]) if len(res.top_scores) else None,
                "joint_top10": [float(s) for s in res.top_scores],
                "best_design": res.top_designs[0] if res.top_designs else None,
                "convergence": [float(c) for c in res.convergence],
                "wall_s": dt_all / args.seeds,
            }
            if res.objective_vectors is not None:
                entry["pareto_front"] = [
                    {"E_pj": float(v[0]), "L_ns": float(v[1]), "A_mm2": float(v[2]),
                     "design": d}
                    for v, d in zip(res.objective_vectors, res.top_designs)]
                for j, v in enumerate(res.objective_vectors):
                    log(f"         front[{j}]: E={v[0]:.4g}pJ L={v[1]:.4g}ns "
                          f"A={v[2]:.4g}mm2")
            if args.separate:
                sep = separate_search(seed + 1000, ws, **kw)
                cross = {}
                for wname, r in sep.items():
                    best_on_all = None
                    if len(r.top_genomes):
                        s_all, _ = rescore_designs(
                            r.top_genomes, ws, objective=rescore_obj,
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
                log(f"         separate: {json.dumps(cross)}")
            results.append(entry)

    if args.out and log is not _quiet:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        log(f"[search] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
