"""Joint / separate hardware-workload search drivers (paper Sec. III-A, IV).

Every driver is a thin wrapper: it builds ``core.engine.SearchRequest``s
and hands them to a ``core.engine.SearchEngine`` on the requested device.

``joint_search``/``run_search`` one GA over the full workload set (the
                           paper's method): the objective reduces metrics
                           with max over workloads.
``separate_search``      the baseline: one GA per single workload, all W
                           as one batched GA (``batched=False`` runs them
                           one by one; both give identical results).
``batched_search``       B independent GAs (any mix of workload sets,
                           seeds and objective weights) as one batched GA.
``joint_search_batched`` multi-seed joint search on top of it.
``rescore_designs``      re-evaluate any designs on any workload set or
                           objective (the paper's "failed designs").

Seeds are integers.  A search's randomness (its seeded population and
its uniform blocks) comes from generators seeded by that integer, so a
search gives the same result alone or in a batch.  With
``prng="threefry"`` a seed ``s`` means ``PRNGKey(s)`` and every draw is the
JAX package's from that key (``key=``/``keys=`` pass threefry keys
directly), so a seed or key replays the JAX package's search.
``init_genomes`` and ``u_blocks`` replace the seeded population and the
drawn blocks.
``objective="pareto"`` runs NSGA-II front search (the result holds the
``pareto_k`` best front members and their (E, L, A) vectors), and
``obj_weights`` the exponent-weighted objective.
``mesh=`` (``launch.mesh.make_search_mesh``) runs the searches on a mesh
of ranks, the independent GAs split along ``search`` and each population
along ``data`` (``core.distributed``); every rank calls the driver alike
and gets every result, bit for bit the ``mesh=None`` ones.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import prng as tf
from repro_torch.core import space
from repro_torch.core.engine import (  # noqa: F401 (re-exported API)
    BACKENDS,
    EngineFault,
    NonFiniteScoreError,
    SearchEngine,
    SearchRequest,
    SearchResult,
    _top_unique,
    _workload_weights,
    default_engine,
    empty_partial_result,
    largest_workload_index,
    make_eval_fn,
    seed_population,
    seed_population_batched,
)
from repro_torch.core.objectives import make_objective
from repro_torch.device import resolve_device
from repro_torch.imc.cost import EvalResult, evaluate_designs
from repro_torch.imc.tech import TECH, TechParams
from repro_torch.workloads.pack import WorkloadSet


def _engine(engine: Optional[SearchEngine], device, prng: str,
            pipelined: Optional[bool] = None) -> SearchEngine:
    """The engine a driver call runs on: ``engine`` when given (its stream
    must be ``prng``; its own ``pipelined`` governs), else the shared
    engine of the device, stream and ``pipelined`` (the JAX package's
    ``_resolve_engine``; ``fused`` has no effect on an engine, so the
    drivers take it and pick no engine by it)."""
    if engine is None:
        return default_engine(device, prng, pipelined=bool(pipelined))
    if engine.prng != prng:
        raise ValueError(f"engine draws prng={engine.prng!r}, the call asks for {prng!r}")
    return engine


def split_seed(seed: int, n: int) -> List[int]:
    """``n`` independent integer seeds derived from ``seed``: the torch
    streams' counterpart of ``jax.random.split(key, n)`` for per-workload
    searches (the threefry streams split the key itself)."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


def run_search(
    seed: int,
    ws: WorkloadSet,
    *,
    objective: str = "ela",
    area_constr: float = 150.0,
    pop_size: int = 40,
    generations: int = 10,
    top_k: int = 10,
    pareto_k: int = 10,
    obj_weights: Optional[Sequence[float]] = None,
    init_genomes=None,
    u_blocks=None,
    tech: TechParams = TECH,
    backend: str = "dense",
    device="cuda",
    engine: Optional[SearchEngine] = None,
    fused: Optional[bool] = None,
    pipelined: Optional[bool] = None,
    prng: str = "torch",
    key=None,
    mesh=None,
) -> SearchResult:
    """One joint search = a single-request engine run.  ``prng="threefry"``
    replays the JAX package's ``run_search(PRNGKey(seed))``, or its
    ``run_search(key)`` given ``key``.  On a ``mesh`` its one row runs on
    every rank with the population split along ``data``.  ``pipelined``
    pins the engine's thin path: the same result fields, except that
    ``result.ga`` is ``None``; ``fused`` is accepted and has no effect
    (``SearchEngine``)."""
    req = SearchRequest(
        ws=ws, objective=objective, area_constr=float(area_constr),
        seed=int(seed), backend=backend, pop_size=int(pop_size),
        generations=int(generations), top_k=int(top_k), pareto_k=int(pareto_k),
        obj_weights=None if obj_weights is None else tuple(float(w) for w in obj_weights),
        tech=tech, init_genomes=init_genomes, u_blocks=u_blocks,
        key=None if key is None else tf.key_data(tf.as_key(key)),
    )
    return _engine(engine, device, prng, pipelined).run([req], mesh=mesh)[0]


def joint_search(seed: int, ws: WorkloadSet, **kw) -> SearchResult:
    return run_search(seed, ws, **kw)


def batched_search(
    seeds: Sequence[int],
    feats,
    mask,
    *,
    names: Optional[Sequence] = None,
    objective: str = "ela",
    obj_weights=None,
    area_constr: float = 150.0,
    pop_size: int = 40,
    generations: int = 10,
    top_k: int = 10,
    pareto_k: int = 10,
    init_genomes=None,
    u_blocks=None,
    tech: TechParams = TECH,
    backend: str = "dense",
    device="cuda",
    engine: Optional[SearchEngine] = None,
    fused: Optional[bool] = None,
    pipelined: Optional[bool] = None,
    prng: str = "torch",
    keys=None,
    mesh=None,
) -> List[SearchResult]:
    """B independent searches: ``seeds`` (B,), ``feats`` (B, W, L, 6),
    ``mask`` (B, W, L), optional ``init_genomes`` (B, P, n),
    ``u_blocks`` (B, G, tot) and ``obj_weights`` (B, 3), each element's
    exponent weights.  Element b gives the same result as
    ``run_search(seeds[b], ...)`` on its own workload set.  ``keys`` (B, 2)
    threefry keys (``prng="threefry"``) replace the seeds' ``PRNGKey``s, as
    the JAX package's ``batched_search(keys, ...)`` takes them.  ``mesh``
    splits the B searches along ``search`` and each population along
    ``data``.  ``fused`` and ``pipelined`` as in ``run_search``."""
    feats = torch.as_tensor(np.asarray(feats, np.float32))
    mask = torch.as_tensor(np.asarray(mask, bool))
    B = len(seeds)
    if names is None:
        names_b = [tuple(f"w{j}" for j in range(feats.shape[1]))] * B
    elif isinstance(names[0], str):
        names_b = [tuple(names)] * B
    else:
        names_b = [tuple(n) for n in names]
    if obj_weights is not None:
        obj_weights = np.asarray(obj_weights, np.float64)
    if keys is not None:
        keys = tf.key_data(tf.as_key(keys))
        if len(keys) != B:
            raise ValueError(f"{len(keys)} keys for {B} searches")
    reqs = [
        SearchRequest(
            ws=WorkloadSet(names=names_b[b], feats=feats[b], mask=mask[b]),
            objective=objective,
            obj_weights=(None if obj_weights is None
                         else tuple(float(w) for w in obj_weights[b])),
            area_constr=float(area_constr),
            seed=int(seeds[b]),
            backend=backend,
            pop_size=int(pop_size),
            generations=int(generations),
            top_k=int(top_k),
            pareto_k=int(pareto_k),
            tech=tech,
            init_genomes=None if init_genomes is None else init_genomes[b],
            u_blocks=None if u_blocks is None else u_blocks[b],
            key=None if keys is None else keys[b],
        )
        for b in range(B)
    ]
    return _engine(engine, device, prng, pipelined).run(reqs, mesh=mesh)


@spans.span("search.joint")
def joint_search_batched(seeds: Sequence[int], ws: WorkloadSet, **kw) -> List[SearchResult]:
    """Multi-seed joint search: one GA per seed, all in one batched GA."""
    B = len(seeds)
    feats = ws.feats[None].expand(B, *ws.feats.shape)
    mask = ws.mask[None].expand(B, *ws.mask.shape)
    return batched_search(seeds, feats, mask, names=ws.names, **kw)


@spans.span("search.separate")
def separate_search(
    seed: int,
    ws: WorkloadSet,
    *,
    share_init=None,
    u_blocks=None,
    batched: bool = True,
    prng: str = "torch",
    key=None,
    mesh=None,
    **kw,
) -> Dict[str, SearchResult]:
    """One single-workload GA per workload (the paper's baseline).
    Per-workload seeds come from ``split_seed(seed, W)``; with
    ``prng="threefry"`` per-workload keys are ``split(key, W)`` of ``key``
    or ``PRNGKey(seed)``, as in the JAX package.  ``share_init`` (P, n)
    seeds every GA with the same population and ``u_blocks`` (W, G, tot)
    gives each its blocks.  ``batched=False`` runs the W searches one by
    one; both paths return identical results.  ``mesh`` splits the W
    searches along ``search`` (the batched path only)."""
    if mesh is not None and not batched:
        raise ValueError("mesh= requires the batched path (batched=True)")
    seeds = split_seed(seed, ws.n)
    keys = None
    if prng == "threefry":
        k = tf.PRNGKey(seed) if key is None else tf.as_key(key)
        keys = tf.key_data(tf.split(k, ws.n))
    elif key is not None:
        raise ValueError("separate_search(key=...) needs prng='threefry'")
    kw["prng"] = prng
    if batched:
        init = None
        if share_init is not None:
            init = [share_init] * ws.n
        res = batched_search(
            seeds,
            ws.feats[:, None],  # (W, 1, L, 6): one workload per element
            ws.mask[:, None],
            names=[(n,) for n in ws.names],
            init_genomes=init,
            u_blocks=u_blocks,
            keys=keys,
            mesh=mesh,
            **kw,
        )
        return dict(zip(ws.names, res))
    out = {}
    for i, name in enumerate(ws.names):
        out[name] = run_search(
            seeds[i], ws.subset([i]), init_genomes=share_init,
            u_blocks=None if u_blocks is None else u_blocks[i],
            key=None if keys is None else keys[i], **kw)
    return out


@spans.span("search.rescore")
def rescore_designs(
    genomes,
    ws: WorkloadSet,
    *,
    objective: str = "ela",
    area_constr: float = 150.0,
    tech: TechParams = TECH,
    device="cuda",
) -> Tuple[np.ndarray, EvalResult]:
    """Scores + full metrics of given designs on a (possibly different)
    workload set, on the dense path: the paper's cross-evaluation."""
    dev = resolve_device(device)
    g = torch.as_tensor(np.asarray(genomes, np.float32), device=dev)
    r = evaluate_designs(space.decode(g), ws, tech)
    s = make_objective(objective, area_constr)(r)
    return s.cpu().numpy(), r
