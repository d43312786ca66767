"""DSE engine: search request -> batch plan -> dispatch / harvest.

The service layer of the search stack.  The search functions of
``core.search`` and the DSE service (``serve.dse``) are thin wrappers
over three pieces:

  * ``SearchRequest`` - one search: workload set, objective, area
    constraint, seed, backend, GA sizes, and the scheduling metadata
    ``priority`` / ``deadline_s`` (never part of a result).
  * ``plan_batch`` - groups requests by signature (backend, pop size,
    generations, tech, and the exact (W, L) for the dense backends; the
    table backend carries no shape, so any workload sets pack together),
    orders them by a scheduling policy (fifo / priority / edf) and cuts
    each group into chunks of at most ``max_slots`` searches.
  * ``SearchEngine`` - runs a plan as one batched GA (``core.ga``) with an
    explicit search axis B: ``dispatch`` enqueues the work on the device
    without waiting for it, ``harvest`` brings the results back and
    finalizes them on the host.

Within a plan:

  * **Objectives** are per-slot data: a kind index and an area constraint
    (``objectives.make_indexed_objective``), bit-identical per element to
    the static ``make_objective`` path.  Requests with ``obj_weights`` run
    the exponent-weighted objective (per-slot weights, one area per
    group), and ``objective="pareto"`` requests run NSGA-II over (E, L, A)
    vectors (per-slot areas); each family plans into its own signature
    group.
  * **Workload sets**: the table backend stacks each request's own tables
    (``WorkloadSet.tables``), zero-padded along W: a zero row fits
    everywhere and adds 0 to the objective's max, so a request scores the
    same alone and in any batch.  The dense backends group by exact
    (W, L), so their tensors are never padded.
  * **Seeds** are data: each slot draws its initial population and its
    uniform blocks from its own streams, so a slot's results do not depend
    on its batch-mates.  ``SearchEngine(prng="torch")`` (the default)
    draws from ``torch.Generator``s seeded by the request's seed, whose
    streams differ between the CPU and CUDA; ``prng="threefry"`` draws
    what the JAX package draws from ``PRNGKey(seed)`` or the request's
    ``key`` (``core.prng``), the same bits on every device.
    ``stream_tag`` names the stream in every cache key.
    The rejection seeder runs on a CUDA stream of the engine's own, so its
    early exit waits for its own rounds, never for a GA still queued;
    ``SearchEngine(direct_seed=True)`` samples table-backend pools from
    the feasible cells instead (``_seed_direct``), with no host sync.

A plan of S requests runs S rows: ``BatchPlan.slots`` (the chunk size
of its group, as the JAX package plans it) enters ``plan_key`` only, and
the pad rows the JAX package runs to reuse a compiled program are dropped
before launch, since nothing here is compiled per shape.

Backends: ``"dense"`` (``imc.cost``, plain PyTorch), ``"kernel"`` (the
same model with its layer sums from the ``imc_eval`` kernel) and
``"table"`` (``imc.tables``, whose generation step on the card is the
``ga_gen_step`` kernel).  They are the JAX package's ``"jnp"``,
``"pallas"`` and ``"table"``.

Meshes: ``SearchEngine(mesh=...)`` (or ``mesh=`` on ``run`` / ``dispatch``
/ ``execute``) runs every plan on a ``launch.mesh.make_search_mesh``
layout, one process per card, every rank the same program: a rank seeds
and runs the GAs of its rows along ``search`` with each population split
along ``data`` (``core.distributed``), and every rank gets the whole
plan's results, bit for bit the meshless ones.  The mesh's first rank (the
lead) owns the result cache and the segment checkpoints; a resumed plan
takes the lead's restored state and each rank keeps its rows (the JAX
engine's ``_place_state``).

``fused`` is accepted and has no effect: the JAX package's two survival
programs give the same bits, and the port has one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.checkpoint import store
from repro_torch.core import distributed as mdist
from repro_torch.core import prng as tf
from repro_torch.core import space
from repro_torch.core.ga import (
    CapturePlan,
    GAResult,
    GAState,
    GAThin,
    ParetoThin,
    block_layout,
    ga_epilogue_batched,
    init_ga_state_batched,
    run_ga_batched,
    run_ga_batched_segment,
    run_ga_batched_thin,
    run_pareto_batched,
)
from repro_torch.core.objectives import (
    OBJECTIVE_INDEX,
    OBJECTIVE_WEIGHTS,
    PARETO,
    make_indexed_objective,
    make_objective,
    make_pareto_objective,
    make_weighted_objective,
)
from repro_torch.device import resolve_device
from repro_torch.imc.cost import _true_div, evaluate_designs_arrays, valid_vt_mask
from repro_torch.imc.tables import WorkloadTables, evaluate_genomes_tables
from repro_torch.imc.tech import TECH, TechParams
from repro_torch.kernels.ga_gen_step.ops import ga_gen_step
from repro_torch.kernels.imc_eval.ops import (
    design_stack,
    evaluate_designs_kernel_arrays,
    kernel_epilogue,
    layer_sums,
)
from repro_torch.workloads.pack import WorkloadSet

BACKENDS = ("dense", "kernel", "table")
PRNGS = ("torch", "threefry")
MAX_SLOTS = 64  # searches per batched GA
# objective tails of an eval ctx: (kind, area), (3,) weights, or area
INDEXED, WEIGHTED = "indexed", "weighted"


def stream_tag(device, prng: str = "torch") -> str:
    """Names the random stream a seed draws on ``device``: the same seed
    gives other designs on the CPU's and on CUDA's generator, and on
    threefry, so cache and checkpoint keys must tell them apart.  The
    threefry tag keeps the device type: the dense cost model's float sums
    may still round apart across devices."""
    dev = torch.device(device).type
    if prng == "torch":
        return f"repro_torch seed streams v1, torch.Generator({dev})"
    if prng == "threefry":
        return f"repro_torch seed streams v1, jax threefry2x32 partitionable({dev})"
    raise ValueError(f"prng must be one of {PRNGS}, got {prng!r}")


@dataclasses.dataclass
class SearchResult:
    workload_names: Tuple[str, ...]
    objective: str
    ga: Optional[GAResult]  # host history; None for thin (pipelined) results
    # and for empty partials
    top_designs: List[Dict[str, float]]  # decoded, deduped, best-first
    top_scores: np.ndarray
    top_genomes: np.ndarray
    convergence: np.ndarray  # best-so-far score per generation
    valid: bool = True  # False: no finite-scoring design in the history
    partial: bool = False  # True: search stopped before its full budget
    generations: int = -1  # generations actually applied (-1 = full budget)
    # objective="pareto" only: per-member (max_W E, max_W L, A) vectors,
    # (kept, 3) float32 aligned with top_genomes / top_scores
    objective_vectors: Optional[np.ndarray] = None


class EngineFault(RuntimeError):
    """A launch failed for good (retries spent, or no retry path).
    ``partials``, when the plan had advanced, holds one anytime
    ``SearchResult`` (``partial=True``) per plan request (``None`` where
    nothing was evaluated), so a service can resolve those requests with
    their best so far."""

    def __init__(self, msg: str, *, partials: Optional[List[Optional[SearchResult]]] = None,
                 generations_done: int = 0):
        super().__init__(msg)
        self.partials = partials
        self.generations_done = int(generations_done)


class NonFiniteScoreError(EngineFault):
    """The per-segment guard tripped: a launch produced NaN scores (+inf
    is the normal score of an infeasible design, so the guard is NaN-only)."""


# --------------------------------------------------------- eval callbacks
@lru_cache(maxsize=None)
def _ctx_eval(tech: TechParams, backend: str, tail: str = INDEXED,
              area_constr: float = 0.0) -> Callable:
    """``eval_fn(genomes (B, P, n), ctx) -> scores`` for a backend and an
    objective tail.  ``ctx = (workload part..., tail leaves)``: the
    workload part is ``(feats, mask)`` for the dense backends and
    ``(tables,)`` for the table backend; the tail is ``kind (B,), area
    (B,)`` (``INDEXED``: scores (B, P)), ``weights (B, 3)`` (``WEIGHTED``,
    with ``area_constr`` fixed: scores (B, P)) or ``area (B,)`` (``PARETO``:
    (B, P, 3) vectors), or none for a static kind of ``OBJECTIVE_INDEX``
    (scored under ``area_constr``).  The table callback of the indexed tail carries
    ``gen_step``, the ``ga_gen_step`` kernel wrapper, which the GA runs in
    place of its plain generation step; the kernel scores only that
    tail, so the weighted and Pareto tails run the plain step.  The dense
    and kernel callbacks of every tail but Pareto carry a
    ``capture_plan`` (``core.ga.CapturePlan``), so the GA replays their
    plain generations on CUDA as graphs: one for the dense backend, and
    for the kernel backend two around the ``imc_eval`` operator call."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if tail == INDEXED:
        indexed = make_indexed_objective()

        def obj(r, ctx):
            return indexed(r, ctx[-2], ctx[-1])
    elif tail == WEIGHTED:
        weighted = make_weighted_objective(area_constr)

        def obj(r, ctx):
            return weighted(r, ctx[-1])
    elif tail == PARETO:
        vector = make_pareto_objective()

        def obj(r, ctx):
            return vector(r, ctx[-1])
    elif tail in OBJECTIVE_INDEX:  # a static kind: no tail leaves
        static = make_objective(tail, area_constr)

        def obj(r, ctx):
            return static(r)
    else:
        raise ValueError(f"objective tail must be {INDEXED!r}, {WEIGHTED!r}, "
                         f"{PARETO!r} or a kind of {tuple(OBJECTIVE_INDEX)}, got {tail!r}")

    if backend == "table":
        def ev(genomes, ctx):
            return evaluate_genomes_tables(genomes, ctx[0], tech)
    elif backend == "kernel":
        def ev(genomes, ctx):
            return evaluate_designs_kernel_arrays(
                space.decode(genomes), ctx[0], ctx[1], tech)

        def head(children, ctx):
            d = space.decode(children)
            return d, design_stack(d)

        def call(mid, ctx):
            return layer_sums(mid[1], ctx[0], ctx[1], tech)

        def tail_scores(children, mid, sums, ctx):
            return obj(kernel_epilogue(mid[0], sums, tech), ctx)
    else:
        def ev(genomes, ctx):
            return evaluate_designs_arrays(space.decode(genomes), ctx[0], ctx[1], tech)

    def eval_fn(genomes: torch.Tensor, ctx) -> torch.Tensor:
        return obj(ev(genomes, ctx), ctx)

    if backend == "table" and tail == INDEXED:
        def gen_step(pop, scores, u, ctx, **kw):
            return ga_gen_step(pop, scores, u, ctx, tech=tech, **kw)

        eval_fn.gen_step = gen_step
    elif backend == "kernel" and tail != PARETO:
        eval_fn.capture_plan = CapturePlan(head=head, call=call, tail=tail_scores)
    elif backend == "dense" and tail != PARETO:
        eval_fn.capture_plan = CapturePlan()
    return eval_fn


def make_eval_fn(
    ws: WorkloadSet,
    objective: str,
    area_constr: float,
    tech: TechParams = TECH,
    *,
    backend: str = "dense",
    device="cuda",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``eval_fn(genomes (P, n)) -> scores (P,)`` of one scalar objective
    kind on ``device``: ``"dense"`` (``imc.cost``), ``"kernel"`` (the
    imc_eval kernel on CUDA) or ``"table"`` (the set's grid tables: O(W)
    lookups per design, no layer axis).  The workload tensors move to the
    device once, here."""
    if objective not in OBJECTIVE_INDEX:
        raise ValueError(f"objective must be one of {tuple(OBJECTIVE_INDEX)}, got {objective!r}")
    dev = resolve_device(device)
    fn = _ctx_eval(tech, backend, objective, float(area_constr))
    if backend == "table":
        ctx = (WorkloadTables(*(t.to(dev) for t in ws.tables(tech))),)
    else:
        ctx = (ws.feats.to(dev), ws.mask.to(dev))

    def eval_fn(genomes) -> torch.Tensor:
        return fn(torch.as_tensor(genomes, dtype=torch.float32, device=dev), ctx)

    return eval_fn


def _workload_weights(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Crossbar-demand proxy per workload (total weight count K * N * groups);
    the single definition of "largest" shared by every seeding path."""
    return (feats[..., 1] * feats[..., 2] * feats[..., 5] * mask).sum(-1)


def largest_workload_index(ws: WorkloadSet) -> int:
    """Largest = most crossbar demand at a reference design (most weights)."""
    return int(torch.argmax(_workload_weights(ws.feats, ws.mask.to(torch.float32))))


# ----------------------------------------------------------------- seeding
def _candidate_draws(source, n_cand: int, dev) -> Callable:
    """``draw(open_) -> (B, n_cand, n)``: one round's candidates per slot.
    ``source`` is one ``torch.Generator`` per slot, or a (B, 2) threefry
    key tensor: then each round is ``key, k = split(key)`` and
    ``uniform(k, (n_cand, n))`` per slot, as the JAX package's seeder
    draws, and a slot whose pool is full before the round (``open_``
    False) keeps its key, as a vmapped ``while_loop`` keeps a finished
    element's state."""
    if isinstance(source, torch.Tensor):
        keys = source.to(dev)

        def draw(open_: torch.Tensor) -> torch.Tensor:
            nonlocal keys
            ks = tf.split(keys)  # (B, 2, 2)
            keys = torch.where(open_[:, None], ks[:, 0], keys)
            return space.random_genomes(n_cand, key=ks[:, 1])
        return draw

    def draw(open_: torch.Tensor) -> torch.Tensor:
        return torch.stack([space.random_genomes(n_cand, generator=g, device=dev)
                            for g in source])
    return draw


def _seed_rounds(source, feats: torch.Tensor, mask: torch.Tensor, pop_size: int,
                 oversample: int, max_rounds: int, tech: TechParams, stream=None):
    """Batched rejection sampler against ONE workload per slot (feats
    (B, L, 6), mask (B, L)).  Each round every slot draws ``pop_size *
    oversample`` candidates from its own stream (``_candidate_draws``),
    keeps those that fit and are V/f-valid, and fills its next free pool
    slots.  The rounds stop once every pool is full, which the host reads
    after each round.  With ``stream`` (the current CUDA stream, which the
    rounds run on) that read waits on an event recorded on it, so it never
    waits for other streams' work; without, it is a plain read.  A slot
    draws the same candidates whatever batch or stream it runs in."""
    B = feats.shape[0]
    dev = feats.device
    n_cand = pop_size * oversample
    draw = _candidate_draws(source, n_cand, dev)
    pool = torch.zeros((B, pop_size + 1, space.N_GENES), dtype=torch.float32,
                       device=dev)  # row pop_size collects the overflow
    count = torch.zeros((B,), dtype=torch.int64, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]
    if stream is not None:
        flag = torch.empty((), dtype=torch.bool, pin_memory=True)
        round_done = torch.cuda.Event()
    for _ in range(int(max_rounds)):
        with spans.span("engine.seed_round"):
            cand = draw(count < pop_size)
            r = evaluate_designs_arrays(space.decode(cand), feats[:, None],
                                        mask[:, None], tech)
            ok = r.fits[..., 0] & r.valid  # (B, n_cand)
            pos = count[:, None] + torch.cumsum(ok.to(torch.int64), dim=1) - 1
            idx = torch.where(ok & (pos < pop_size), pos, pop_size)
            pool[bidx, idx] = cand
            count = torch.clamp_max(count + ok.sum(dim=1), pop_size)
            full = (count >= pop_size).all()
            if stream is not None:
                flag.copy_(full, non_blocking=True)
                round_done.record(stream)
                round_done.synchronize()
                full = flag
            full = bool(full)
        if full:
            break
    return pool[:, :pop_size], count


def _seed_pools(source, feats, mask, pop_size, *, tech, oversample=64,
                max_rounds=8, stream=None):
    """(pools (B, P, n), counts (B,)) on the device, not checked: each slot
    rejects against its own largest workload of feats (B, W, L, 6), drawing
    from ``source`` (one ``torch.Generator`` per slot, or (B, 2) threefry
    keys, which are moved to the seeding stream's device there).  The
    early exit costs a host read a round and saves the rounds after the
    pools fill (one round nearly always, at P=40).  With a CUDA ``stream``
    the rounds run on it (feats and mask must be ready there) and the
    caller's stream waits for them before it uses the pools; the reads
    wait for the seeding work only, not for a GA queued on the caller's
    stream."""
    main = None if stream is None else torch.cuda.current_stream(feats.device)
    with contextlib.nullcontext() if stream is None else torch.cuda.stream(stream):
        li = torch.argmax(_workload_weights(feats, mask.to(torch.float32)), dim=1)
        bidx = torch.arange(feats.shape[0], device=feats.device)
        pools, counts = _seed_rounds(source, feats[bidx, li], mask[bidx, li],
                                     int(pop_size), int(oversample), int(max_rounds),
                                     tech, stream)
    if stream is not None:
        seeded = torch.cuda.Event()
        seeded.record(stream)
        main.wait_event(seeded)
        # made on the seeding stream, used on the caller's: keep their memory
        # until the caller's stream is done with them
        pools.record_stream(main)
        counts.record_stream(main)
    return pools, counts


# the six jointly constrained fields of the direct seeder: the demand
# table's axes, then the capacity axes; their mixed-radix order defines
# the 6-D cell index the CDF runs over
_CAP_FIELDS = ("rows", "cols", "bits_cell", "c_per_tile", "t_per_router", "g_per_chip")


def _seed_cells_cdf(demand_l: np.ndarray) -> np.ndarray:
    """Host CDF of ONE workload's feasible cells: ``demand[rows, cols,
    bits] <= c_per_tile * t_per_router * g_per_chip`` over the 6-D grid
    (the rejection seeder's fit test; ``glb_mb`` and the V/f pair are
    handled apart), as the inclusive int64 prefix sum over the flat (R, C,
    Bc, Cpt, Tpr, Gpc) cell order."""
    cpt = np.asarray(space.SPACE["c_per_tile"], np.float32)
    tpr = np.asarray(space.SPACE["t_per_router"], np.float32)
    gpc = np.asarray(space.SPACE["g_per_chip"], np.float32)
    cap = cpt[:, None, None] * tpr[None, :, None] * gpc[None, None, :]
    feas = demand_l[:, :, :, None, None, None] <= cap[None, None, None]
    return np.cumsum(feas.reshape(-1).astype(np.int64))


_VT_CDF: Dict[tuple, Tuple[torch.Tensor, int]] = {}


def _vt_cdf(tech: TechParams, device) -> Tuple[torch.Tensor, int]:
    """The (V, Tc) validity mask's inclusive prefix sum on ``device`` and
    its total, per (tech, grid, device)."""
    key = (tech, space.grid_token(), str(device))
    hit = _VT_CDF.get(key)
    if hit is None:
        with spans.span("tables.build", key="vt_cdf"):
            cdf = torch.cumsum(valid_vt_mask(tech).reshape(-1).to(torch.int64), 0)
            hit = _VT_CDF[key] = (cdf.to(device), int(cdf[-1]))
    return hit


def _seed_direct(u: torch.Tensor, cdf6: torch.Tensor, tech: TechParams = TECH, *,
                 jit_division: bool = False):
    """Direct inverse-CDF seeder over the feasible cells of each slot's
    largest workload (the table backend's alternative to the rejection
    rounds): ``u`` (B, P, N_GENES + 2) uniforms, ``cdf6`` (B, n_cells)
    ``_seed_cells_cdf`` stacks.  The last two uniforms pick a feasible
    6-D cell and a V/f-valid (v_op, t_cycle) pair by ``searchsorted``;
    each gene then sits uniformly inside its cell with a [1e-3, 1 - 1e-3]
    margin, so ``space.decode_indices`` maps it back to that cell.  Every
    design fits the largest workload and is V/f-valid by construction,
    with no host sync.  Returns (pools (B, P, n), counts (B,)): a count is
    P, or 0 when the workload fits nowhere.

    The gene's division by its axis size is an IEEE division, the bits of
    the JAX package's ``_seed_direct`` called eagerly; ``jit_division``
    multiplies by the float32 reciprocal instead, as XLA compiles the
    division by a constant inside the JAX engine's jitted seeder (one ulp
    apart in ~13% of the genes, never across a cell), so the threefry
    streams replay the JAX engine's pools bit for bit."""
    dev = u.device
    sizes = {f: len(space.SPACE[f]) for f in space.FIELDS}
    total6 = cdf6[:, -1:]  # (B, 1)
    cdf2, total2 = _vt_cdf(tech, dev)
    # the selector stays below the count, also where float32 rounding of
    # u * total would reach it
    k6 = torch.minimum((u[..., -2] * total6.to(torch.float32)).to(torch.int64),
                       total6 - 1)
    k2 = torch.clamp_max((u[..., -1] * float(total2)).to(torch.int64), total2 - 1)
    sel6 = torch.searchsorted(cdf6, k6, right=True)
    sel2 = torch.searchsorted(cdf2, k2, right=True)
    idx = {}
    rem = sel6
    for f in reversed(_CAP_FIELDS):
        idx[f] = rem % sizes[f]
        rem = rem // sizes[f]
    idx["t_cycle_ns"] = sel2 % sizes["t_cycle_ns"]
    idx["v_op"] = sel2 // sizes["t_cycle_ns"]
    genes = []
    for j, f in enumerate(space.FIELDS):
        frac = torch.clamp(u[..., j], 1e-3, 1.0 - 1e-3)
        cell = (torch.floor(u[..., j] * sizes[f]) if f == "glb_mb"  # any cell
                else idx[f].to(torch.float32))
        if jit_division:
            recip = float(np.float32(1.0) / np.float32(sizes[f]))
            genes.append((cell + frac) * torch.full((), recip, device=dev))
        else:
            genes.append(_true_div(cell + frac, float(sizes[f])))
    pools = torch.stack(genes, dim=-1)
    P = u.shape[1]
    counts = torch.where(total6[:, 0] > 0, P, 0)
    return pools, counts


def _check_seeded(counts: np.ndarray, pop_size: int, names=None) -> None:
    if counts.min() < pop_size:
        bad = int(np.argmin(counts))
        what = f" (workloads {names[bad]})" if names is not None else ""
        raise RuntimeError(
            f"could not seed {pop_size} valid designs for batch element {bad}"
            f"{what}; {int(counts[bad])} found")


def _objective_label(req: "SearchRequest") -> str:
    """``SearchResult.objective``: the kind, the kind a weight vector
    reproduces, or ``weighted(...)``."""
    if req.obj_weights is None:
        return req.objective
    inv = {v: k for k, v in OBJECTIVE_WEIGHTS.items()}
    w = tuple(float(v) for v in req.obj_weights)
    return inv.get(w, f"weighted{w}")


def seed_population_batched(
    source,
    feats: torch.Tensor,
    mask: torch.Tensor,
    pop_size: int,
    *,
    tech: TechParams = TECH,
    oversample: int = 64,
    max_rounds: int = 8,
    mesh=None,
) -> torch.Tensor:
    """Per-slot seeding: feats (B, W, L, 6), mask (B, W, L) -> pools
    (B, pop_size, n), drawn from ``source`` (one ``torch.Generator`` per
    slot, or (B, 2) threefry keys).  Each slot rejects against its own
    largest workload (paper Sec. III-C: designs failing it, or V/f-invalid,
    are dropped).  With ``mesh`` each rank seeds its rows along ``search``
    and every rank returns the whole batch's pools."""
    B = int(feats.shape[0])
    if mesh is not None:
        rows = mdist.search_rows(mesh, B)
        source, feats, mask = source[rows], feats[rows], mask[rows]
    pools, counts = _seed_pools(source, feats, mask, pop_size, tech=tech,
                                oversample=oversample, max_rounds=max_rounds)
    if mesh is not None:
        pools = mdist.gather_rows(mesh, pools, B)
        counts = mdist.gather_rows(mesh, counts, B)
    _check_seeded(counts.cpu().numpy(), pop_size)
    return pools


def seed_population(
    seed: int,
    ws: WorkloadSet,
    pop_size: int,
    *,
    tech: TechParams = TECH,
    oversample: int = 64,
    max_rounds: int = 8,
    device="cuda",
    key=None,
) -> torch.Tensor:
    """Random init of one search from ``seed``'s seeding generator, or,
    given a threefry ``key``, the population the JAX package's
    ``seed_population(key, ...)`` draws; designs failing the largest
    workload (or V/f-invalid) are discarded (paper Sec. III-C)."""
    dev = resolve_device(device)
    if key is None:
        source = [_slot_generators(int(seed), dev)[0]]
    else:
        source = tf.as_key(key, dev)[None]
    return seed_population_batched(
        source, ws.feats[None].to(dev), ws.mask[None].to(dev), pop_size,
        tech=tech, oversample=oversample, max_rounds=max_rounds)[0]


def _slot_generators(seed: int, device) -> Tuple[torch.Generator, torch.Generator]:
    """A search's two independent streams: seeding and the GA blocks."""
    g_seed = torch.Generator(device=device)
    g_seed.manual_seed(2 * int(seed))
    g_ga = torch.Generator(device=device)
    g_ga.manual_seed(2 * int(seed) + 1)
    return g_seed, g_ga


# ------------------------------------------------------------- result prep
def _mixed_radix_codes(idx: np.ndarray) -> np.ndarray:
    """(..., 9) grid indices -> one int64 code per design (injective)."""
    sizes = space.GRID_SIZES.astype(np.int64)
    strides = np.concatenate(
        [np.cumprod(sizes[::-1])[::-1][1:], np.ones(1, np.int64)]
    )
    return idx.astype(np.int64) @ strides


def _top_unique(
    genomes: np.ndarray, scores: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Best-k designs, unique in *decoded grid index* space: sort by score
    (stable), keep each grid cell's first (best) occurrence, drop
    non-finite scores (they sort last)."""
    codes = _mixed_radix_codes(space.decode_indices_np(genomes))
    order = np.argsort(scores, kind="stable")
    _, first = np.unique(codes[order], return_index=True)
    first.sort()  # positions within `order`, ascending = best-first
    keep = order[first]
    keep = keep[np.isfinite(scores[keep])][:k]
    return genomes[keep], scores[keep]


@spans.span("engine.finalize")
def _finalize_batch(
    ga_np: GAResult, requests: Sequence["SearchRequest"],
) -> List[SearchResult]:
    """Per-slot results of one launch from its host history: decode, the
    mixed-radix design codes, the stable score argsort and the convergence
    scan run once over (S, (G+1)*P) arrays; only the tiny per-slot
    unique/top-k selection loops in Python."""
    S = len(requests)
    G1, P, n = ga_np.genomes.shape[1:]
    flat_g = ga_np.genomes[:S].reshape(S, G1 * P, n)
    flat_s = ga_np.scores[:S].reshape(S, G1 * P)
    idx = space.decode_indices_np(flat_g.reshape(-1, n)).reshape(S, G1 * P, n)
    codes = _mixed_radix_codes(idx)  # (S, G1*P)
    order = np.argsort(flat_s, axis=1, kind="stable")
    conv = np.minimum.accumulate(ga_np.scores[:S].min(axis=2), axis=1)
    finite = np.isfinite(flat_s)
    out = []
    for i, r in enumerate(requests):
        o = order[i]
        _, first = np.unique(codes[i][o], return_index=True)
        first.sort()
        keep = o[first]
        keep = keep[finite[i][keep]][: r.top_k]
        top_g, top_s = flat_g[i][keep], flat_s[i][keep]
        out.append(SearchResult(
            workload_names=tuple(r.ws.names),
            objective=_objective_label(r),
            ga=GAResult(*(f[i] for f in ga_np)),
            top_designs=space.design_dicts_from_indices(idx[i][keep]),
            top_scores=top_s,
            top_genomes=top_g,
            convergence=conv[i],
            valid=bool(len(top_s)),
            partial=False,
            generations=int(G1) - 1,
        ))
    return out


@spans.span("engine.finalize")
def _finalize_batch_thin(
    thin_np: GAThin, requests: Sequence["SearchRequest"], *, partial: bool = False,
) -> List[SearchResult]:
    """``_finalize_batch`` over the thin epilogue's outputs: the device
    already picked each slot's best unique designs (K = the plan's largest
    ``top_k``, in rank order), so a request keeps its own ``top_k`` prefix:
    the designs the history path keeps, with ``ga=None``."""
    out = []
    for i, r in enumerate(requests):
        kept = int(min(int(thin_np.n_kept[i]), r.top_k))
        top_g = thin_np.top_genomes[i][:kept]
        top_s = thin_np.top_scores[i][:kept]
        conv = thin_np.convergence[i]
        out.append(SearchResult(
            workload_names=tuple(r.ws.names),
            objective=_objective_label(r),
            ga=None,
            top_designs=space.design_dicts_from_indices(space.decode_indices_np(top_g)),
            top_scores=top_s,
            top_genomes=top_g,
            convergence=conv,
            valid=bool(kept),
            partial=bool(partial),
            generations=int(conv.shape[-1]) - 1,
        ))
    return out


@spans.span("engine.finalize")
def _finalize_batch_pareto(
    thin_np: ParetoThin, requests: Sequence["SearchRequest"],
    *, history: Optional[tuple] = None,
) -> List[SearchResult]:
    """Host finalize of a Pareto plan: the device epilogue picked each
    slot's front members in crowded order (K = the plan's largest
    ``pareto_k``), so a request keeps its own ``pareto_k`` prefix with the
    members' (E, L, A) vectors.  ``history`` is the host ``(genomes_hist,
    objs_hist)`` of a sequential engine; its scalar proxy (E*L)*A (the
    ``ela`` bits) makes the attached ``ga`` readable by every history
    consumer."""
    sh_np = None
    if history is not None:
        gh_np, oh_np = history
        sh_np = oh_np[..., 0] * oh_np[..., 1] * oh_np[..., 2]
    out = []
    for i, r in enumerate(requests):
        kept = int(min(int(thin_np.n_kept[i]), int(r.pareto_k)))
        top_g = thin_np.top_genomes[i][:kept]
        conv = thin_np.convergence[i]
        out.append(SearchResult(
            workload_names=tuple(r.ws.names),
            objective=PARETO,
            ga=None if sh_np is None else _history_result(gh_np[i], sh_np[i]),
            top_designs=space.design_dicts_from_indices(space.decode_indices_np(top_g)),
            top_scores=thin_np.top_scores[i][:kept],
            top_genomes=top_g,
            convergence=conv,
            valid=bool(kept),
            partial=False,
            generations=int(conv.shape[-1]) - 1,
            objective_vectors=thin_np.top_vectors[i][:kept],
        ))
    return out


def _history_result(gh_i: np.ndarray, sh_i: np.ndarray) -> GAResult:
    """A host ``GAResult`` over one slot's (g+1, P, .) history; the first
    minimum is the best, as in ``ga.run_ga_batched``."""
    n = gh_i.shape[-1]
    flat_s = sh_i.reshape(-1)
    b = int(np.argmin(flat_s)) if flat_s.size else 0
    return GAResult(
        genomes=gh_i, scores=sh_i,
        best_genome=gh_i.reshape(-1, n)[b] if flat_s.size else np.zeros(n, np.float32),
        best_score=flat_s[b] if flat_s.size else np.float32(np.inf),
    )


def _finalize(ga: GAResult, names: Sequence[str], objective: str, top_k: int,
              *, partial: bool = False) -> SearchResult:
    """One search's result from its host history (the segmented path and
    anytime partials)."""
    G1, P, n = ga.genomes.shape
    top_g, top_s = _top_unique(ga.genomes.reshape(-1, n), ga.scores.reshape(-1), top_k)
    return SearchResult(
        workload_names=tuple(names),
        objective=objective,
        ga=ga,
        top_designs=space.design_dicts_from_indices(space.decode_indices_np(top_g)),
        top_scores=top_s,
        top_genomes=top_g,
        convergence=np.minimum.accumulate(ga.scores.min(axis=1)),
        valid=bool(len(top_s)),
        partial=bool(partial),
        generations=int(G1) - 1,
    )


def empty_partial_result(req: "SearchRequest") -> SearchResult:
    """The anytime result of a request that never had a good launch: no
    designs, ``valid=False``, ``partial=True``."""
    return SearchResult(
        workload_names=tuple(req.ws.names),
        objective=_objective_label(req),
        ga=None,
        top_designs=[],
        top_scores=np.zeros((0,), np.float32),
        top_genomes=np.zeros((0, space.N_GENES), np.float32),
        convergence=np.zeros((0,), np.float32),
        valid=False,
        partial=True,
        generations=0,
    )


# ------------------------------------------------------- request -> plan
@dataclasses.dataclass(frozen=True, eq=False)
class SearchRequest:
    """One DSE query, as data.  ``init_genomes`` (P, n) and ``u_blocks``
    (G, tot) replace the seeded population and the drawn uniform blocks
    when given; neither is modified.  ``key`` ((2,) uint32 words, e.g.
    ``np.asarray`` of a jax key) replaces ``PRNGKey(seed)`` on an engine
    with ``prng="threefry"``; an engine on the torch streams refuses it.
    ``obj_weights`` (w_E, w_L, w_A) switches the request to the
    exponent-weighted objective; otherwise ``objective`` is a kind of
    ``objectives.OBJECTIVES`` or ``"pareto"`` (NSGA-II front search, whose
    result holds the ``pareto_k`` best front members).

    ``priority`` (0 = most urgent) and ``deadline_s`` (seconds from
    submit) are scheduling metadata for ``plan_batch``'s policies and the
    service: they never enter ``signature()``, a cache key or a result."""

    ws: WorkloadSet
    objective: str = "ela"
    area_constr: float = 150.0
    seed: int = 0
    backend: str = "dense"
    pop_size: int = 40
    generations: int = 10
    top_k: int = 10
    tech: TechParams = TECH
    init_genomes: Optional[object] = None
    u_blocks: Optional[object] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    obj_weights: Optional[Tuple[float, ...]] = None
    # objective="pareto" only: front members a result returns (crowded
    # order); hashed by the cache and plan keys, not part of signature()
    pareto_k: int = 10
    key: Optional[object] = None

    def prng_key(self) -> np.ndarray:
        """The threefry key's words (2,) uint32: ``key``, or
        ``PRNGKey(seed)``."""
        if self.key is None:
            return tf.key_data(tf.PRNGKey(self.seed))
        return tf.key_data(tf.as_key(self.key))

    def signature(self) -> tuple:
        """Requests with equal signatures run as one batched GA.  The table
        backend reduced the layer axis away, so its signature carries no
        workload shape; the dense backends group by their exact (W, L).
        The objective family closes it: indexed kinds, weighted (one
        area), or Pareto."""
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.objective == PARETO:
            if self.obj_weights is not None:
                raise ValueError("objective='pareto' is incompatible with obj_weights")
            if int(self.pareto_k) < 1:
                raise ValueError(f"pareto_k must be >= 1, got {self.pareto_k!r}")
            obj: tuple = (PARETO,)
        elif self.obj_weights is not None:
            if len(self.obj_weights) != 3:
                raise ValueError(f"obj_weights must be (w_E, w_L, w_A), got "
                                 f"{self.obj_weights!r}")
            obj = (WEIGHTED, float(self.area_constr))
        elif self.objective not in OBJECTIVE_INDEX:
            raise ValueError(
                f"objective must be one of {tuple(OBJECTIVE_INDEX)} or "
                f"{PARETO!r} (or pass obj_weights), got {self.objective!r}")
        else:
            obj = (INDEXED,)
        shape = (() if self.backend == "table"
                 else (int(self.ws.feats.shape[0]), int(self.ws.feats.shape[1])))
        return (self.backend, int(self.pop_size), int(self.generations),
                self.tech, shape, obj)


def _f32(x) -> torch.Tensor:
    """A float32 host tensor of an array-like or a tensor (on any device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32)
    return torch.tensor(np.asarray(x, np.float32))


def _array_bytes(x) -> Tuple[tuple, bytes]:
    """(shape, float32 bytes) of an array-like or tensor, for hashing."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    return a.shape, a.tobytes()


def hash_stream(h, req: SearchRequest) -> None:
    """Feed the identity of a request's randomness to ``h``: its seed, its
    threefry key when given, and the given population and blocks that
    replace the seeded ones."""
    h.update(repr(("seed", int(req.seed))).encode())
    if req.key is not None:
        h.update(repr(("key", tuple(int(w) for w in req.prng_key()))).encode())
    for name in ("init_genomes", "u_blocks"):
        x = getattr(req, name)
        if x is not None:
            shape, raw = _array_bytes(x)
            h.update(repr((name, shape)).encode())
            h.update(raw)


@dataclasses.dataclass
class BatchPlan:
    """One launch: ``len(requests)`` searches of one signature group.
    ``slots`` is the group's chunk size (the JAX package runs that many
    rows, its pad rows repeating the first request; here only the real
    requests run); ``pad_w``/``pad_l`` are the group-wide padded workload
    shape."""

    signature: tuple
    requests: List[SearchRequest]
    indices: List[int]  # positions in the submitted request list
    slots: int
    pad_w: int
    pad_l: int


def plan_key(plan: BatchPlan, device="cuda", prng: str = "torch") -> str:
    """Content hash of everything that determines a plan's GA trajectory
    on ``device``: workload fingerprints, objectives, areas, tech, GA
    sizes, each request's random stream (its seed or key, given blocks and
    population, and the stream ``prng`` draws on the device), the slot
    shape and the grid.  Stable across processes: the checkpoint directory
    name, so a killed drain's restart finds its own saved state, and never
    another tech's, another device's or another stream's."""
    h = hashlib.sha256()
    h.update(stream_tag(device, prng).encode())
    for r in plan.requests:
        h.update(r.ws.fingerprint().encode())
        h.update(repr((
            r.objective, r.obj_weights, float(r.area_constr), r.backend,
            int(r.pop_size), int(r.generations), int(r.top_k), int(r.pareto_k),
            r.tech,
        )).encode())
        hash_stream(h, r)
    h.update(repr((int(plan.slots), int(plan.pad_w), int(plan.pad_l))).encode())
    h.update(space.grid_token().encode())
    return h.hexdigest()[:24]


# ------------------------------------------------------ scheduling policy
@dataclasses.dataclass(frozen=True)
class RequestMeta:
    """Scheduling facts the policies key on, per queued request: ``seq``
    the submit order (the FIFO key and the tie-break), ``wait_s`` the time
    queued (priority aging), ``deadline_s`` the absolute deadline on the
    scheduler's clock (``None`` = none)."""

    seq: int
    priority: int = 0
    wait_s: float = 0.0
    deadline_s: Optional[float] = None


class SchedulingPolicy:
    """Maps a queued request to a sortable urgency key (lower = sooner).
    The planner stable-sorts the queue by it before grouping, so a policy
    decides which requests share a chunk and which chunk launches first,
    never the chunk shapes."""

    name = "fifo"

    def key(self, req: SearchRequest, meta: RequestMeta) -> tuple:
        return (meta.seq,)


class PriorityPolicy(SchedulingPolicy):
    """Strict priority (0 = most urgent) with aging: a request waiting
    ``aging_s`` seconds gains one level, so every priority eventually
    launches.  ``aging_s=None`` is strict priority (can starve)."""

    name = "priority"

    def __init__(self, aging_s: Optional[float] = 30.0):
        if aging_s is not None and aging_s <= 0:
            raise ValueError(f"aging_s must be positive or None, got {aging_s}")
        self.aging_s = aging_s

    def key(self, req: SearchRequest, meta: RequestMeta) -> tuple:
        p = float(meta.priority)
        if self.aging_s is not None:
            p -= meta.wait_s / self.aging_s
        return (p, meta.seq)


class EDFPolicy(SchedulingPolicy):
    """Earliest deadline first, then submit order; requests without a
    deadline run after every one with."""

    name = "edf"

    def key(self, req: SearchRequest, meta: RequestMeta) -> tuple:
        d = float("inf") if meta.deadline_s is None else float(meta.deadline_s)
        return (d, meta.seq)


POLICIES = {"fifo": SchedulingPolicy, "priority": PriorityPolicy, "edf": EDFPolicy}


def get_policy(policy) -> SchedulingPolicy:
    """A policy name or an already-built ``SchedulingPolicy``."""
    if isinstance(policy, SchedulingPolicy):
        return policy
    cls = POLICIES.get(policy)
    if cls is None:
        raise ValueError(f"policy must be one of {tuple(POLICIES)} or a "
                         f"SchedulingPolicy, got {policy!r}")
    return cls()


@spans.span("engine.plan")
def plan_batch(
    requests: Sequence[SearchRequest],
    *,
    max_slots: int = MAX_SLOTS,
    policy="fifo",
    meta: Optional[Sequence[RequestMeta]] = None,
    slot_hints: Optional[Dict[tuple, int]] = None,
) -> List[BatchPlan]:
    """Group requests by signature and cut each group into chunks, in the
    policy's order.  A group of ``total`` requests gets ``slots =
    min(total, max_slots)``; ``slot_hints`` (signature -> a slot count used
    before) rounds a smaller group up to it, never down.  The queue is
    stable-sorted by the policy's key before grouping, so chunk members
    are in key order and ``plans[0]`` is the launch the policy wants next.
    ``meta`` comes from the service; bare calls derive it from the
    requests (submit order = list order, no wait)."""
    pol = get_policy(policy)
    if meta is None:
        meta = [RequestMeta(seq=i, priority=int(r.priority), wait_s=0.0,
                            deadline_s=r.deadline_s)
                for i, r in enumerate(requests)]
    keys = [pol.key(r, m) for r, m in zip(requests, meta)]
    order = sorted(range(len(requests)), key=keys.__getitem__)
    groups: Dict[tuple, List[int]] = {}
    for i in order:
        groups.setdefault(requests[i].signature(), []).append(i)
    plans: List[BatchPlan] = []
    for sig, idxs in groups.items():
        reqs = [requests[i] for i in idxs]
        pad_w = max(int(r.ws.feats.shape[0]) for r in reqs)
        pad_l = max(int(r.ws.feats.shape[1]) for r in reqs)
        slots = min(len(idxs), int(max_slots))
        hint = (slot_hints or {}).get(sig)
        if hint is not None and slots < hint <= int(max_slots):
            slots = hint
        for lo in range(0, len(idxs), slots):
            plans.append(BatchPlan(signature=sig, requests=reqs[lo:lo + slots],
                                   indices=idxs[lo:lo + slots], slots=slots,
                                   pad_w=pad_w, pad_l=pad_l))
    plans.sort(key=lambda p: keys[p.indices[0]])
    return plans


# ----------------------------------------------------------------- engine
def _rows(mesh, n: int) -> Tuple[slice, bool]:
    """This rank's rows of a plan of ``n`` and whether they split (a
    meshless engine runs them all)."""
    if mesh is None:
        return slice(0, n), False
    return mdist.search_rows(mesh, n), mdist.rows_split(mesh, n)


def _pack_host(reqs: Sequence[SearchRequest], W: int, L: int):
    """Slot-packed host feats (S, W, L, 6) and mask (S, W, L), zero-padded
    and masked past each request's own shape."""
    feats = np.zeros((len(reqs), W, L, 6), np.float32)
    mask = np.zeros((len(reqs), W, L), bool)
    for i, r in enumerate(reqs):
        w, l = r.ws.feats.shape[:2]
        feats[i, :w, :l] = r.ws.feats.cpu().numpy()
        mask[i, :w, :l] = r.ws.mask.cpu().numpy()
    return feats, mask


@dataclasses.dataclass
class _Staged:
    """Device tensors on their way to the host: pinned copies enqueued
    behind the work that makes them, and the event that marks them done
    (``None`` on the CPU, where the tensors are the host arrays)."""

    host: List[torch.Tensor]
    event: Optional[object]
    cls: Optional[type]  # the NamedTuple the fields came from, or None


@dataclasses.dataclass
class _LaunchPrep:
    """Everything a launch needs before its GA runs."""

    ctx: tuple
    eval_fn: Callable
    init: Optional[torch.Tensor]  # (S, P, n) initial populations
    u: Optional[torch.Tensor]  # (G, S, tot) the GA's uniform stream
    seed_check: Optional[Callable]  # raises if a pool came up short
    # on a mesh: this rank's rows of the plan (all of them when they do not
    # split), and whether they split, so the outputs are gathered
    rows: slice = slice(None)
    split: bool = False


@dataclasses.dataclass
class PendingLaunch:
    """A dispatched plan that ``harvest`` has not read yet.  One payload is
    set: ``thin`` (the staged thin epilogue: pipelined), ``ga`` (the staged
    history: sequential), ``pareto`` (a Pareto plan's staged front, with
    ``history`` on a sequential engine) or ``results`` (finalized already:
    the sequential segmented path, which syncs per segment anyway)."""

    plan: BatchPlan
    thin: Optional[_Staged] = None
    ga: Optional[_Staged] = None
    results: Optional[List[SearchResult]] = None
    seed_check: Optional[Callable] = None
    # Pareto plans: the staged ParetoThin, and (sequential engines) the
    # staged genome and objective-vector histories
    pareto: Optional[_Staged] = None
    history: Optional[Tuple[_Staged, _Staged]] = None
    mesh: Optional[object] = None  # the mesh it ran on: only its lead caches
    seq: int = 0  # a service's launch number on a mesh (serve.dse)
    launch: int = 0  # the engine's launch number (``SearchEngine.launches``)


class SearchEngine:
    """Runs batch plans as batched GAs on one device.

    Knobs (all off by default):

      * ``segment_gens`` - run each plan as ceil(G / k) segments of k
        generations (``core.ga.run_ga_batched_segment``, the same bits as
        one run) with a NaN guard after every segment.
      * ``segment_retries`` - how often a failed or NaN segment runs again
        from the last good ``GAState`` before the plan gives up with an
        ``EngineFault`` carrying anytime partials.
      * ``checkpoint_dir`` - save the ``GAState`` and the history every
        ``checkpoint_every`` segments under ``checkpoint_dir/<plan_key>``
        (``checkpoint.store``); an identical plan resumes from the newest
        committed step, and a finished plan clears its directory.
      * ``result_cache`` - a ``serve.cache.ResultCache`` for this device:
        finished requests persist under their own content key, and
        ``run`` resolves cached requests without planning them.
      * ``pipelined`` - the thin path: each launch ends in the thin
        epilogue on the device and brings back (S, K, n) genomes, (S, K)
        scores and (S, G+1) convergence instead of the history; ``run``
        seeds every plan, then launches them all before harvesting the
        first, so the host's finalize of one plan overlaps the device's
        work on the next.  Results equal the sequential path's except
        ``ga`` is ``None``.
      * ``direct_seed`` - table-backend plans seed from the feasible-cell
        CDF of each request's largest workload (``_seed_direct``; CDFs
        cached per workload set, tech and grid) instead of the rejection
        rounds: other pools, the same guarantees, no host sync.  The other
        backends keep the rejection seeder, as in the JAX package.
      * ``fused`` - accepted and without effect (the JAX package's two
        survival programs give the same bits; the port has one).
      * ``mesh`` - a ``launch.mesh.make_search_mesh`` layout (``run``,
        ``dispatch`` and ``execute`` also take one per call): each rank runs
        its rows of every plan with each population split along ``data``,
        and gets the whole plan's results (``core.distributed``).  Every
        rank of the mesh makes the same calls in the same order; the
        engine's ``device`` must be this rank's card (``cuda:LOCAL_RANK``,
        the current device) or the CPU of a CPU mesh.  The lead (the mesh's
        first rank) alone reads and writes the result cache and the
        checkpoints.
      * ``prng`` - ``"torch"`` (default): each request draws from
        ``torch.Generator``s seeded ``2 * seed`` (the population) and
        ``2 * seed + 1`` (the GA blocks).  ``"threefry"``: each request
        draws what the JAX package's engine draws from its key
        (``req.key`` or ``PRNGKey(req.seed)``): ``k_seed, k_ga =
        split(key)``, the seeder's rounds from ``k_seed`` and the GA's
        block of generation g from ``split(k_ga, G)[g]``.  The keys are
        split on the host (a few words); a plan's whole (G, S, tot) block
        stream is one batched ``core.prng.uniform`` on the device.

    Pareto plans (``objective="pareto"``) run single-shot also with
    ``segment_gens``: NSGA-II carries state a ``GAState`` does not hold.

    The rejection seeder reads its pools' counts once a round to stop once
    they are full.  On CUDA its rounds run on the engine's seeding stream
    and the read waits on an event of that stream, so a dispatch behind a
    plan in flight does not wait for that plan's GA; the engine's stream
    waits for the seeder before it uses the pools.  The NSGA-II front peel
    reads the device every few fronts.  Nothing else in ``dispatch`` waits:
    copies to the host go to pinned buffers behind the work, and the
    seeding check moves to ``harvest``.  ``transfer_bytes`` counts the
    bytes brought to the host at the engine's sync point, ``launches`` the
    plans run."""

    def __init__(self, *, device="cuda", max_slots: int = MAX_SLOTS,
                 segment_gens: Optional[int] = None, segment_retries: int = 1,
                 checkpoint_dir: Optional[str] = None, checkpoint_every: int = 1,
                 result_cache=None, pipelined: bool = False, mesh=None,
                 fused: Optional[bool] = None, direct_seed: bool = False,
                 prng: str = "torch"):
        if fused not in (None, True, False):
            raise ValueError(f"fused must be None, True or False, got {fused!r}")
        self.fused = fused
        self.direct_seed = bool(direct_seed)
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            mdist.check_device(mesh, self.device)
        self.stream = stream_tag(self.device, prng)  # refuses an unknown prng
        self.prng = prng
        self._seed_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        cache_stream = getattr(result_cache, "stream", None)
        if cache_stream is not None and cache_stream != self.stream:
            raise ValueError(f"result cache keys {cache_stream!r}, this engine "
                             f"draws {self.stream!r}")
        self.max_slots = int(max_slots)
        self.pipelined = bool(pipelined)
        self.transfer_bytes = 0
        self.launches = 0
        self.segment_gens = None if segment_gens is None else int(segment_gens)
        self.segment_retries = int(segment_retries)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = max(1, int(checkpoint_every))
        self.result_cache = result_cache
        # content-keyed caches of what a warm drain repacks: each request's
        # W-padded host tables, and the slot-packed device tensors
        self._padded_tables: Dict[tuple, tuple] = {}
        self._packed_workloads: Dict[tuple, tuple] = {}
        self._stacked_tables: Dict[tuple, WorkloadTables] = {}
        # direct-seeder CDFs: per request (host) and per plan (device)
        self._seed_cdfs: Dict[tuple, np.ndarray] = {}
        self._stacked_seed_cdfs: Dict[tuple, torch.Tensor] = {}

    # ------------------------------------------------------------ planning
    def check_request(self, req: SearchRequest) -> None:
        """Refuse a threefry ``key`` on the torch streams: it would be
        ignored."""
        if req.key is not None and self.prng != "threefry":
            raise ValueError("SearchRequest.key needs SearchEngine(prng='threefry'); "
                             f"this engine draws {self.stream!r}")

    def _mesh(self, mesh):
        """The mesh of a call: its own, else the engine's."""
        if mesh is None:
            return self.mesh
        if mesh is not self.mesh:
            mdist.check_device(mesh, self.device)
        return mesh

    def run(self, requests: Sequence[SearchRequest], *, mesh=None) -> List[SearchResult]:
        """Plan and run; results align with ``requests``.  With a
        ``result_cache``, cached requests resolve without a launch (on a
        mesh the lead looks them up and sends every rank its hits)."""
        mesh = self._mesh(mesh)
        for r in requests:
            self.check_request(r)
        out: List[Optional[SearchResult]] = [None] * len(requests)
        todo = list(range(len(requests)))
        if self.result_cache is not None and mdist.is_lead(mesh):
            todo = []
            for i, r in enumerate(requests):
                hit = self.result_cache.get(r)
                if hit is not None:
                    out[i] = hit
                else:
                    todo.append(i)
        if mesh is not None:
            out, todo = mdist.broadcast_object(mesh, (out, todo))
        plans = plan_batch([requests[i] for i in todo], max_slots=self.max_slots)
        if self.pipelined:
            # seeding syncs (see the class docstring): seed every plan while
            # the stream is empty, then queue the launches back to back
            preps = [None if self._segmented(p)
                     else self._prepare(p, mesh=mesh, launch=self.launches + 1 + i)
                     for i, p in enumerate(plans)]
            pending = [self.dispatch(p, mesh=mesh, prep=prep)
                       for p, prep in zip(plans, preps)]
            for plan, pend in zip(plans, pending):
                for i, res in zip(plan.indices, self.harvest(pend)):
                    out[todo[i]] = res
        else:
            for plan in plans:
                for i, res in zip(plan.indices, self.execute(plan, mesh=mesh)):
                    out[todo[i]] = res
        return out  # type: ignore[return-value]

    def reset_transfer_stats(self) -> None:
        self.transfer_bytes = 0
        self.launches = 0

    # ------------------------------------------------- host <-> device
    def _to_device(self, x) -> torch.Tensor:
        """A host array or tensor on the engine's device; on CUDA through a
        pinned buffer, so the copy does not wait for queued work."""
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if self.device.type != "cuda" or t.device.type == "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _stage(self, x) -> _Staged:
        """Enqueue the copy of a tensor (or a NamedTuple of tensors) to the
        host without waiting for it."""
        cls = type(x) if isinstance(x, tuple) else None
        fields = list(x) if cls is not None else [x]
        if self.device.type != "cuda":
            return _Staged(host=[f.detach() for f in fields], event=None, cls=cls)
        host = [torch.empty(f.shape, dtype=f.dtype, pin_memory=True).copy_(
            f, non_blocking=True) for f in fields]
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return _Staged(host=host, event=event, cls=cls)

    @spans.span("engine.sync")
    def _sync(self, x):
        """The engine's one device-to-host sync point: waits for a staged
        copy (or stages and waits for ``x``) and counts its bytes into
        ``transfer_bytes``.  Returns numpy arrays in ``x``'s structure."""
        st = x if isinstance(x, _Staged) else self._stage(x)
        if st.event is not None:
            st.event.synchronize()
        arrs = [h.numpy() for h in st.host]
        self.transfer_bytes += sum(a.nbytes for a in arrs)
        return st.cls(*arrs) if st.cls is not None else arrs[0]

    # ----------------------------------------------------------- execution
    def _padded_request_tables(self, req: SearchRequest, pad_w: int) -> tuple:
        """One request's table leaves (numpy), zero-padded along W to the
        plan width: a zero row fits everywhere and adds 0 to the max over
        workloads, so padding cannot move a real score."""
        key = (req.ws.fingerprint(), req.tech, pad_w, space.grid_token())
        hit = self._padded_tables.get(key)
        if hit is None:
            with spans.span("tables.build", key="padded"):
                leaves = [leaf.numpy() for leaf in req.ws.tables(req.tech)]
                extra = pad_w - leaves[0].shape[0]
                if extra:
                    leaves = [np.pad(leaf, [(0, extra)] + [(0, 0)] * (leaf.ndim - 1))
                              for leaf in leaves]
                hit = self._padded_tables[key] = tuple(leaves)
        return hit

    def _tables(self, reqs: Sequence[SearchRequest], W: int, tech: TechParams):
        """The slot-stacked tables (leaves (S, W, ...)) on the device."""
        key = (tuple(r.ws.fingerprint() for r in reqs), W, tech, space.grid_token())
        hit = self._stacked_tables.get(key)
        if hit is None:
            with spans.span("tables.build", key="stacked"):
                per = [self._padded_request_tables(r, W) for r in reqs]
                hit = WorkloadTables(*(self._to_device(np.stack([t[f] for t in per]))
                                       for f in range(len(per[0]))))
                self._stacked_tables[key] = hit
        return hit

    def _packed(self, reqs: Sequence[SearchRequest], W: int, L: int):
        """Slot-packed feats (S, W, L, 6) and mask (S, W, L) on the device,
        zero-padded and masked past each request's own shape.  On CUDA they
        are uploaded on the seeding stream, which the rejection seeder reads
        them on (an upload on the engine's stream would wait for its queued
        GA), and the engine's stream waits for that upload."""
        key = (tuple(r.ws.fingerprint() for r in reqs), W, L)
        hit = self._packed_workloads.get(key)
        if hit is None:
            with spans.span("tables.build", key="packed"):
                host = _pack_host(reqs, W, L)
                if self._seed_stream is None:
                    hit = tuple(self._to_device(a) for a in host)
                else:
                    main = torch.cuda.current_stream(self.device)
                    with torch.cuda.stream(self._seed_stream):
                        hit = tuple(self._to_device(a) for a in host)
                        uploaded = torch.cuda.Event()
                        uploaded.record(self._seed_stream)
                    main.wait_event(uploaded)
                    for t in hit:
                        t.record_stream(main)
                self._packed_workloads[key] = hit
        return hit

    def execute(self, plan: BatchPlan, *, mesh=None,
                on_progress: Optional[Callable[[int, SearchResult], None]] = None,
                ) -> List[SearchResult]:
        """One launch (or, with ``segment_gens``, a chain of guarded
        segments: the same bits); results in plan order.  ``on_progress(i,
        partial)`` gets a monotone best-so-far snapshot of plan request i
        after every segment but the last (the segmented path only)."""
        return self.harvest(self.dispatch(plan, mesh=mesh, on_progress=on_progress))

    def _segmented(self, plan: BatchPlan) -> bool:
        k = self.segment_gens
        r0 = plan.requests[0]
        return k is not None and 0 < k < int(r0.generations) and r0.objective != PARETO

    def dispatch(self, plan: BatchPlan, *, mesh=None,
                 on_progress: Optional[Callable[[int, SearchResult], None]] = None,
                 prep: Optional[_LaunchPrep] = None) -> PendingLaunch:
        """Seed and launch a plan without waiting for its GA: the GA (and,
        when ``pipelined``, the thin epilogue) is enqueued and the copies of
        its outputs to the host ride in the ``PendingLaunch``.  ``prep`` is
        the plan's ``_prepare``, when the caller seeded it already.  The
        segmented path runs its guarded segments here (it syncs per segment
        by design) and leaves only the final read to ``harvest``.  On a mesh
        this rank runs its rows and the outputs are gathered here, so every
        rank stages the whole plan's."""
        mesh = self._mesh(mesh)
        r0 = plan.requests[0]
        n = self.launches + 1
        with spans.span("engine.dispatch", key=n):
            if self._segmented(plan):
                pend = self._dispatch_segmented(plan, mesh, self.segment_gens,
                                                on_progress=on_progress)
                pend.launch = n
                return pend
            if prep is None:
                prep = self._prepare(plan, mesh=mesh)
            self.launches += 1
            S = len(plan.requests)

            def whole(x):
                """The plan's every row of a local output (a tensor or a
                NamedTuple of them)."""
                if not prep.split:
                    return x
                if isinstance(x, tuple):
                    return type(x)(*(mdist.gather_rows(mesh, f, S) for f in x))
                return mdist.gather_rows(mesh, x, S)

            kw = dict(pop_size=int(r0.pop_size), generations=int(r0.generations),
                      init_genomes=prep.init, ctx=prep.ctx, u_blocks=prep.u)
            out = dict(plan=plan, seed_check=prep.seed_check, mesh=mesh, launch=n)
            if r0.objective == PARETO:
                # both engine modes run the same front epilogue, so their
                # fronts are the same bits; the sequential one also keeps the
                # history
                kw["top_k"] = max(int(r.pareto_k) for r in plan.requests)
                if self.pipelined:
                    thin = run_pareto_batched(prep.eval_fn, **kw)
                    return PendingLaunch(pareto=self._stage(whole(thin)), **out)
                gh, oh, thin = run_pareto_batched(prep.eval_fn, history=True, **kw)
                return PendingLaunch(pareto=self._stage(whole(thin)),
                                     history=(self._stage(whole(gh)),
                                              self._stage(whole(oh))),
                                     **out)
            if self.pipelined:
                thin = run_ga_batched_thin(prep.eval_fn,
                                           top_k=max(int(r.top_k) for r in plan.requests),
                                           **kw)
                return PendingLaunch(thin=self._stage(whole(thin)), **out)
            ga = run_ga_batched(prep.eval_fn, **kw)
            return PendingLaunch(ga=self._stage(whole(ga)), **out)

    def harvest(self, pending: PendingLaunch) -> List[SearchResult]:
        """Wait for a dispatched plan's outputs, finalize them, and put the
        finished results into the cache: the host half of ``execute``."""
        with spans.span("engine.harvest", key=pending.launch):
            if pending.seed_check is not None:
                pending.seed_check()
            if pending.results is not None:
                results = pending.results
            elif pending.pareto is not None:
                history = (None if pending.history is None
                           else tuple(self._sync(h) for h in pending.history))
                results = _finalize_batch_pareto(self._sync(pending.pareto),
                                                 pending.plan.requests, history=history)
            elif pending.thin is not None:
                results = _finalize_batch_thin(self._sync(pending.thin),
                                               pending.plan.requests)
            else:
                results = _finalize_batch(self._sync(pending.ga), pending.plan.requests)
            self._cache_completed(pending.plan, results, pending.mesh)
        return results

    def _cache_completed(self, plan: BatchPlan, results: Sequence[SearchResult],
                         mesh=None) -> None:
        if self.result_cache is not None and mdist.is_lead(mesh):
            for r, res in zip(plan.requests, results):
                self.result_cache.put(r, res)

    def _prepare(self, plan: BatchPlan, *, mesh=None, fresh: bool = True,
                 launch: Optional[int] = None) -> _LaunchPrep:
        """A plan's device inputs up to the GA launch: the eval ctx and,
        when ``fresh`` (not resuming a checkpoint), the initial populations
        and the uniform stream.  Only the seeder's rounds wait for the
        device, one sync each.  On a mesh, only this rank's rows: their
        workloads, objectives and streams, a rank drawing for its own rows
        alone (one batched threefry pass over their keys), and an eval
        that splits each population along ``data``.  ``launch`` keys its
        spans when it runs before its launch's ``dispatch``."""
        with spans.span("engine.prepare", key=launch):
            rows, split = _rows(mesh, len(plan.requests))
            reqs = plan.requests[rows]
            r0 = reqs[0]
            backend, tech = r0.backend, r0.tech
            W, L = plan.pad_w, plan.pad_l
            if backend == "table":
                ctx: tuple = (self._tables(reqs, W, tech),)
            else:
                ctx = self._packed(reqs, W, L)
            areas = np.array([r.area_constr for r in reqs], np.float32)
            if r0.objective == PARETO:
                ctx = ctx + (self._to_device(areas),)
                eval_fn = _ctx_eval(tech, backend, PARETO)
            elif r0.obj_weights is not None:
                weights = np.array([r.obj_weights for r in reqs], np.float32)
                ctx = ctx + (self._to_device(weights),)
                eval_fn = _ctx_eval(tech, backend, WEIGHTED, float(r0.area_constr))
            else:
                kinds = np.array([OBJECTIVE_INDEX[r.objective] for r in reqs], np.int64)
                ctx = ctx + (self._to_device(kinds), self._to_device(areas))
                eval_fn = _ctx_eval(tech, backend)
            if mesh is not None:
                eval_fn = mdist.split_eval(eval_fn, mesh)
            for r in reqs:
                self.check_request(r)
            init = u = seed_check = None
            if fresh:
                P, G = int(r0.pop_size), int(r0.generations)
                tot = block_layout(P, space.N_GENES).tot
                if self.prng == "threefry":
                    init, counts, need, u = self._threefry_streams(reqs, W, L, G, tot)
                else:
                    gens = [_slot_generators(r.seed, self.device) for r in reqs]
                    init, counts, need = self._init_populations(reqs, [g for g, _ in gens], W, L)
                    u = torch.stack([
                        torch.rand((G, tot), generator=g_ga, device=self.device)
                        if r.u_blocks is None else self._to_device(_f32(r.u_blocks))
                        for r, (_, g_ga) in zip(reqs, gens)
                    ], dim=1)  # (G, S, tot)
                seed_check = self._seed_check(plan, reqs, counts, need, P,
                                              mesh if split else None)
            return _LaunchPrep(ctx=ctx, eval_fn=eval_fn, init=init, u=u,
                               seed_check=seed_check, rows=rows, split=split)

    def _seed_check(self, plan: BatchPlan, reqs, counts, need, P: int, mesh):
        """The check ``harvest`` runs on the seeded pools' counts (``None``
        when no row was seeded).  On a split mesh every rank gathers every
        row's count, seeded here or not (a given population counts P), so
        all ranks raise alike."""
        if mesh is not None:
            full = torch.full((len(reqs),), P, dtype=torch.int64, device=self.device)
            if need:
                full[need] = counts.to(torch.int64)
            counts = mdist.gather_rows(mesh, full, len(plan.requests))
            names = [r.ws.names for r in plan.requests]
        elif not need:
            return None
        else:
            names = [reqs[i].ws.names for i in need]
        staged = self._stage(counts)

        def check():
            _check_seeded(self._sync(staged), P, names)
        return check

    def _threefry_streams(self, reqs, W: int, L: int, G: int, tot: int):
        """(init, counts, need, u (G, S, tot)) of a plan on the threefry streams.
        The keys are split on the host: ``k_seed, k_ga = split(key)`` per
        slot and ``split(k_ga, G)``, a few words each.  The block stream is
        then ONE batched ``uniform`` over the (S, G) keys on the device,
        whatever the plan's size; given ``u_blocks`` replace their slot's."""
        keys = torch.from_numpy(np.stack([r.prng_key() for r in reqs]).astype(np.int64))
        ks = tf.split(keys)  # (S, 2, 2)
        init, counts, need = self._init_populations(reqs, ks[:, 0], W, L)
        drawn = [i for i, r in enumerate(reqs) if r.u_blocks is None]
        u = None
        if drawn:
            k_gen = self._to_device(tf.split(ks[drawn, 1], G))  # (S', G, 2)
            u = tf.uniform(k_gen, (tot,)).transpose(0, 1)  # (G, S', tot)
        if len(drawn) < len(reqs):
            cols = {i: j for j, i in enumerate(drawn)}
            u = torch.stack([
                u[:, cols[i]] if r.u_blocks is None else self._to_device(_f32(r.u_blocks))
                for i, r in enumerate(reqs)], dim=1)
        return init, counts, need, u.contiguous()

    def _init_populations(self, reqs, seed_src, W: int, L: int):
        """(init (S, P, n), counts, need): given ``init_genomes`` are copied
        in, the slots ``need`` are seeded, by the batched rejection seeder
        against the slot-packed feats or, with ``direct_seed`` on the table
        backend, by ``_seed_direct``, with ``counts`` (on the device, not
        read) the designs each found (``None`` when no slot was seeded).
        ``seed_src`` holds each slot's seeding stream: a
        ``torch.Generator`` per slot, or the (S, 2) host tensor of threefry
        keys ``k_seed``."""
        P = int(reqs[0].pop_size)
        need = [i for i, r in enumerate(reqs) if r.init_genomes is None]
        pools: List[Optional[torch.Tensor]] = [None] * len(reqs)
        counts = None
        if need:
            sub = [reqs[i] for i in need]
            threefry = isinstance(seed_src, torch.Tensor)
            src = seed_src[need] if threefry else [seed_src[i] for i in need]
            tech = reqs[0].tech
            with spans.span("engine.seed"):
                if self.direct_seed and reqs[0].backend == "table":
                    if threefry:
                        u = tf.uniform(self._to_device(src), (P, space.N_GENES + 2))
                    else:
                        u = torch.stack([
                            torch.rand((P, space.N_GENES + 2), generator=g,
                                       device=self.device)
                            for g in src])
                    seeded, counts = _seed_direct(u, self._stacked_seed_cdf(sub, tech),
                                                  tech, jit_division=threefry)
                else:
                    feats, mask = self._packed(sub, W, L)
                    if threefry:  # uploaded on the stream the rounds run on
                        with self._on_seed_stream():
                            src = self._to_device(src)
                    seeded, counts = _seed_pools(src, feats, mask, P, tech=tech,
                                                 stream=self._seed_stream)
            for j, i in enumerate(need):
                pools[i] = seeded[j]
        for i, r in enumerate(reqs):
            if r.init_genomes is not None:
                pools[i] = self._to_device(_f32(r.init_genomes))
        return torch.stack(pools), counts, need

    def _on_seed_stream(self):
        return (contextlib.nullcontext() if self._seed_stream is None
                else torch.cuda.stream(self._seed_stream))

    def _request_seed_cdf(self, req: SearchRequest) -> np.ndarray:
        """One request's feasible-cell CDF for the direct seeder (host
        numpy, over its largest workload by the crossbar-demand rule of
        ``largest_workload_index``), per (workload set, tech, grid)."""
        key = (req.ws.fingerprint(), req.tech, space.grid_token())
        hit = self._seed_cdfs.get(key)
        if hit is None:
            with spans.span("tables.build", key="seed_cdf"):
                feats = req.ws.feats.cpu().numpy().astype(np.float32)
                mask = req.ws.mask.cpu().numpy().astype(bool)
                w = (feats[..., 1] * feats[..., 2] * feats[..., 5] * mask).sum(-1)
                demand = req.ws.tables(req.tech).demand.cpu().numpy()
                hit = self._seed_cdfs[key] = _seed_cells_cdf(demand[int(np.argmax(w))])
        return hit

    def _stacked_seed_cdf(self, reqs: Sequence[SearchRequest], tech: TechParams):
        """(S, n_cells) device stack of the requests' seed CDFs, cached on
        their fingerprints."""
        key = (tuple(r.ws.fingerprint() for r in reqs), tech, space.grid_token())
        hit = self._stacked_seed_cdfs.get(key)
        if hit is None:
            with spans.span("tables.build", key="stacked_seed_cdf"):
                hit = self._stacked_seed_cdfs[key] = self._to_device(
                    np.stack([self._request_seed_cdf(r) for r in reqs]))
        return hit

    # ------------------------------------------------- segmented execution
    def _ckpt_dir(self, plan: BatchPlan) -> Optional[Path]:
        if self.checkpoint_dir is None:
            return None
        return Path(self.checkpoint_dir) / plan_key(plan, self.device, self.prng)

    def _partial_results(self, plan: BatchPlan, gh: Optional[np.ndarray],
                         sh: Optional[np.ndarray]) -> List[Optional[SearchResult]]:
        """Anytime results from the accumulated host history (``None`` per
        request when nothing was evaluated)."""
        if gh is None:
            return [None] * len(plan.requests)
        return [_finalize(_history_result(gh[i], sh[i]), r.ws.names, _objective_label(r),
                          r.top_k, partial=True)
                for i, r in enumerate(plan.requests)]

    def _dispatch_segmented(
        self, plan: BatchPlan, mesh, seg: int,
        on_progress: Optional[Callable[[int, SearchResult], None]] = None,
    ) -> PendingLaunch:
        """Advance the plan ``seg`` generations a launch with a NaN guard,
        retries from the last good state, and optional checkpoints; the
        chained segments repeat the single launch bit for bit.  After each
        good segment but the last, ``on_progress`` gets every request's
        best so far, finalized from the history so far (monotone).

        ``pipelined`` keeps the history on the device: the guard reads one
        byte a segment, snapshots go through the thin epilogue, and the
        final epilogue is staged for ``harvest``.  Checkpoints and fault
        partials read the full history at their (cold) boundaries.

        On a mesh a rank advances its rows' state and every segment's
        outputs are gathered, so each rank holds the whole history and
        takes the same guard and retry decisions.  The lead alone reads and
        writes the checkpoints: a restored state goes to every rank, which
        keeps its rows."""
        reqs = plan.requests
        S = len(reqs)
        G = int(plan.requests[0].generations)
        K = max(int(r.top_k) for r in reqs)
        thin = self.pipelined
        ck_dir = self._ckpt_dir(plan)
        lead = mdist.is_lead(mesh)
        rows, split = _rows(mesh, S)

        def whole(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
            return mdist.gather_rows_dim(mesh, t, S, dim) if split else t

        state: Optional[GAState] = None
        done = 0
        gh = sh = None  # (S, done+1, P, n) / (S, done+1, P): numpy, or device if thin
        restored = None
        if ck_dir is not None and lead and store.latest_step(ck_dir) is not None:
            restored, _ = store.restore(ck_dir)
        if ck_dir is not None and mesh is not None:
            restored = mdist.broadcast_object(mesh, restored)
        if restored is not None:
            g_, s_, u_, gen_, gh, sh = restored
            done = int(gen_)
            state = GAState(genomes=self._to_device(g_[rows]),
                            scores=self._to_device(s_[rows]),
                            u=self._to_device(u_[:, rows]), gen=done)
            if thin:
                gh, sh = self._to_device(gh), self._to_device(sh)

        def host_hist():
            if gh is None:
                return None, None
            if thin:
                return self._sync(gh), self._sync(sh)
            return gh, sh

        try:
            prep = self._prepare(plan, mesh=mesh, fresh=state is None)
            self.launches += 1
            if state is None:
                if prep.seed_check is not None:
                    prep.seed_check()
                state = init_ga_state_batched(prep.eval_fn, prep.init, prep.u,
                                              ctx=prep.ctx)
                g0, s0 = whole(state.genomes), whole(state.scores)
                if thin:
                    if bool(torch.isnan(s0).any()):
                        raise NonFiniteScoreError("NaN scores in the seed evaluation")
                    gh, sh = g0[:, None], s0[:, None]
                else:
                    s0 = self._sync(s0)
                    if np.isnan(s0).any():
                        raise NonFiniteScoreError("NaN scores in the seed evaluation")
                    gh, sh = self._sync(g0)[:, None], s0[:, None]
        except EngineFault:
            raise
        except Exception as e:
            raise EngineFault(f"segmented launch setup failed: {e}",
                              partials=self._partial_results(plan, *host_hist())) from e

        seg_idx = 0
        while done < G:
            k_gens = min(seg, G - done)
            attempt = 0
            while True:
                try:
                    new_state, (hg, hs) = run_ga_batched_segment(
                        state, prep.eval_fn, ctx=prep.ctx, generations=k_gens,
                        total_generations=G)
                    hg, hs = whole(hg), whole(hs)
                    if thin:
                        if bool(torch.isnan(hs).any()):
                            raise NonFiniteScoreError(
                                f"NaN scores in segment at generation {done}")
                    else:
                        hs_np = self._sync(hs)
                        if np.isnan(hs_np).any():
                            raise NonFiniteScoreError(
                                f"NaN scores in segment at generation {done}")
                        hg_np = self._sync(hg)
                    break
                except Exception as e:
                    attempt += 1
                    if attempt > self.segment_retries:
                        raise EngineFault(
                            f"segment at generation {done} failed after "
                            f"{attempt} attempts: {e}",
                            partials=self._partial_results(plan, *host_hist()),
                            generations_done=done) from e
                    # a retry runs again from the same (unmodified) state
            if thin:
                gh, sh = torch.cat([gh, hg], dim=1), torch.cat([sh, hs], dim=1)
            else:
                gh = np.concatenate([gh, hg_np], axis=1)
                sh = np.concatenate([sh, hs_np], axis=1)
            state = new_state
            done += k_gens
            seg_idx += 1
            if ck_dir is not None and done < G and seg_idx % self.checkpoint_every == 0:
                # every rank gathers the state; the lead writes it
                ck_state = (whole(state.genomes), whole(state.scores), whole(state.u, 1))
                if lead:
                    hg_ck, hs_ck = host_hist()
                    store.save(ck_dir, done, [self._sync(t) for t in ck_state]
                               + [np.int64(done), hg_ck, hs_ck])
            if on_progress is not None and done < G:
                if thin:
                    snap = self._sync(ga_epilogue_batched(gh, sh, top_k=K))
                    for i, res in enumerate(_finalize_batch_thin(snap, reqs, partial=True)):
                        on_progress(i, res)
                else:
                    for i, r in enumerate(reqs):
                        on_progress(i, _finalize(_history_result(gh[i], sh[i]),
                                                 r.ws.names, _objective_label(r), r.top_k,
                                                 partial=True))

        if ck_dir is not None and lead:
            store.clear(ck_dir)
        if thin:
            return PendingLaunch(plan=plan, mesh=mesh,
                                 thin=self._stage(ga_epilogue_batched(gh, sh, top_k=K)))
        return PendingLaunch(plan=plan, mesh=mesh, results=[
            _finalize(_history_result(gh[i], sh[i]), r.ws.names, _objective_label(r), r.top_k)
            for i, r in enumerate(reqs)])


_ENGINES: Dict[Tuple[str, str, bool], SearchEngine] = {}


def default_engine(device="cuda", prng: str = "torch",
                   pipelined: bool = False) -> SearchEngine:
    """Shared engine per device, stream and engine mode behind the
    ``core.search`` drivers (its caches stay warm from call to call)."""
    dev = resolve_device(device)
    k = (str(dev), prng, bool(pipelined))
    eng = _ENGINES.get(k)
    if eng is None:
        eng = _ENGINES[k] = SearchEngine(device=dev, prng=prng, pipelined=bool(pipelined))
    return eng
