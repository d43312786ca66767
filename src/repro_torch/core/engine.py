"""DSE engine: search requests -> groups -> one batched GA per group.

``SearchRequest`` describes one search (workload set, objective, area
constraint, seed, backend, GA sizes); ``SearchEngine.run`` groups requests
by signature (backend, pop size, generations, tech), packs each group
into one batched GA (``core.ga.run_ga_batched``) with an explicit search
axis ``B``, and finalizes every slot on the host.  Within a group:

  * **Objectives** are per-slot data: a kind index and an area constraint
    (``objectives.make_indexed_objective``), bit-identical per element to
    the static ``make_objective`` path.
  * **Workload sets** are padded to the group's (W, L): masked layers and
    all-zero workloads (or zero table rows on the table backend) are
    exactly neutral under the max-reduction and the fits test.
  * **Seeds** are data: each slot draws its initial population and its
    uniform blocks from its own ``torch.Generator``, so a slot's results do
    not depend on its batch-mates.

Backends: ``"dense"`` (``imc.cost``, plain PyTorch), ``"kernel"`` (the
same model with its layer sums from the ``imc_eval`` kernel) and
``"table"`` (``imc.tables``, whose generation step on the card is the
``ga_gen_step`` kernel).  They are the JAX package's ``"jnp"``,
``"pallas"`` and ``"table"``.

Not ported yet: scheduling policies, pipelined dispatch/harvest, GA
segments, checkpoints, the result cache, direct seeding, meshes, and the
Pareto and weighted objectives.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import space
from repro_torch.core.ga import GAResult, block_layout, run_ga_batched
from repro_torch.core.objectives import OBJECTIVE_INDEX, make_indexed_objective
from repro_torch.device import resolve_device
from repro_torch.imc.cost import evaluate_designs_arrays
from repro_torch.imc.tables import build_tables_arrays, evaluate_genomes_tables
from repro_torch.imc.tech import TECH, TechParams
from repro_torch.kernels.ga_gen_step.ops import ga_gen_step
from repro_torch.kernels.imc_eval.ops import evaluate_designs_kernel_arrays
from repro_torch.workloads.pack import WorkloadSet

BACKENDS = ("dense", "kernel", "table")
MAX_SLOTS = 64  # searches per batched GA


@dataclasses.dataclass
class SearchResult:
    workload_names: Tuple[str, ...]
    objective: str
    ga: Optional[GAResult]  # host (numpy) history of this search
    top_designs: List[Dict[str, float]]  # decoded, deduped, best-first
    top_scores: np.ndarray
    top_genomes: np.ndarray
    convergence: np.ndarray  # best-so-far score per generation
    valid: bool = True  # False: no finite-scoring design in the history
    partial: bool = False  # True: search stopped before its full budget
    generations: int = -1  # generations actually applied (-1 = full budget)
    objective_vectors: Optional[np.ndarray] = None  # Pareto family (not ported)


# --------------------------------------------------------- eval callbacks
@lru_cache(maxsize=None)
def _ctx_eval(tech: TechParams, backend: str) -> Callable:
    """``eval_fn(genomes (B, P, n), ctx) -> scores (B, P)`` for a backend,
    with ``ctx = (workload part..., kind (B,), area (B,))``: the workload
    part is ``(feats, mask)`` for the dense backends and ``(tables,)`` for
    the table backend.  The table callback carries ``gen_step``, the
    ``ga_gen_step`` kernel wrapper, which the GA runs in place of its
    plain generation step."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    obj = make_indexed_objective()

    if backend == "table":
        def ev(genomes, ctx):
            return evaluate_genomes_tables(genomes, ctx[0], tech)
    elif backend == "kernel":
        def ev(genomes, ctx):
            return evaluate_designs_kernel_arrays(
                space.decode(genomes), ctx[0], ctx[1], tech)
    else:
        def ev(genomes, ctx):
            return evaluate_designs_arrays(space.decode(genomes), ctx[0], ctx[1], tech)

    def eval_fn(genomes: torch.Tensor, ctx) -> torch.Tensor:
        return obj(ev(genomes, ctx), ctx[-2], ctx[-1])

    if backend == "table":
        def gen_step(pop, scores, u, ctx, **kw):
            return ga_gen_step(pop, scores, u, ctx, tech=tech, **kw)

        eval_fn.gen_step = gen_step
    return eval_fn


def _eval_ctx(feats: torch.Tensor, mask: torch.Tensor, tech: TechParams,
              backend: str) -> Tuple:
    """The workload half of an eval ``ctx`` for slot-packed feats (B, W, L,
    6) and mask (B, W, L): the raw tensors, or, for the table backend, the
    factorized ``(tables,)`` statistics, reduced over the layer axis here,
    once per batch.  Padded (masked) layers and workloads give zero table
    rows, which fit everywhere and add 0 to the max-reduction."""
    if backend != "table":
        return (feats, mask)
    return (build_tables_arrays(feats, mask, tech),)


def _workload_weights(feats: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Crossbar-demand proxy per workload (total weight count K * N * groups);
    the single definition of "largest" shared by every seeding path."""
    return (feats[..., 1] * feats[..., 2] * feats[..., 5] * mask).sum(-1)


def largest_workload_index(ws: WorkloadSet) -> int:
    """Largest = most crossbar demand at a reference design (most weights)."""
    return int(torch.argmax(_workload_weights(ws.feats, ws.mask.to(torch.float32))))


# ----------------------------------------------------------------- seeding
def _seed_rounds(generators: Sequence[torch.Generator], feats: torch.Tensor,
                 mask: torch.Tensor, pop_size: int, oversample: int,
                 max_rounds: int, tech: TechParams):
    """Batched rejection sampler against ONE workload per slot (feats
    (B, L, 6), mask (B, L)).  Each round every slot draws ``pop_size *
    oversample`` candidates from its own generator, keeps those that fit
    and are V/f-valid, and fills its next free pool slots; rounds repeat
    until every pool is full or ``max_rounds`` is hit.  A slot draws the
    same candidates whatever batch it runs in."""
    B = feats.shape[0]
    dev = feats.device
    n_cand = pop_size * oversample
    pool = torch.zeros((B, pop_size + 1, space.N_GENES), dtype=torch.float32,
                       device=dev)  # row pop_size collects the overflow
    count = torch.zeros((B,), dtype=torch.int64, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]
    for _ in range(int(max_rounds)):
        cand = torch.stack([space.random_genomes(n_cand, generator=g, device=dev)
                            for g in generators])
        r = evaluate_designs_arrays(space.decode(cand), feats[:, None],
                                    mask[:, None], tech)
        ok = r.fits[..., 0] & r.valid  # (B, n_cand)
        pos = count[:, None] + torch.cumsum(ok.to(torch.int64), dim=1) - 1
        idx = torch.where(ok & (pos < pop_size), pos, pop_size)
        pool[bidx, idx] = cand
        count = torch.clamp_max(count + ok.sum(dim=1), pop_size)
        if bool((count >= pop_size).all()):
            break
    return pool[:, :pop_size], count


def seed_population_batched(
    generators: Sequence[torch.Generator],
    feats: torch.Tensor,
    mask: torch.Tensor,
    pop_size: int,
    *,
    tech: TechParams = TECH,
    oversample: int = 64,
    max_rounds: int = 8,
) -> torch.Tensor:
    """Per-slot seeding: feats (B, W, L, 6), mask (B, W, L) -> pools
    (B, pop_size, n).  Each slot rejects against its own largest workload
    (paper Sec. III-C: designs failing it, or V/f-invalid, are dropped)."""
    li = torch.argmax(_workload_weights(feats, mask.to(torch.float32)), dim=1)
    bidx = torch.arange(feats.shape[0], device=feats.device)
    pools, counts = _seed_rounds(generators, feats[bidx, li], mask[bidx, li],
                                 int(pop_size), int(oversample),
                                 int(max_rounds), tech)
    counts = counts.cpu().numpy()
    if counts.min() < pop_size:
        bad = int(np.argmin(counts))
        raise RuntimeError(
            f"could not seed {pop_size} valid designs for batch element {bad} "
            f"({int(counts[bad])} found)"
        )
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
) -> torch.Tensor:
    """Random init of one search from ``seed``; designs failing the largest
    workload (or V/f-invalid) are discarded (paper Sec. III-C)."""
    dev = resolve_device(device)
    g_seed, _ = _slot_generators(int(seed), dev)
    return seed_population_batched(
        [g_seed], ws.feats[None].to(dev), ws.mask[None].to(dev), pop_size,
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
            objective=r.objective,
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


# ---------------------------------------------------------------- requests
@dataclasses.dataclass(frozen=True, eq=False)
class SearchRequest:
    """One DSE query, as data.  ``init_genomes`` (P, n) and ``u_blocks``
    (G, tot) replace the seeded population and the drawn uniform blocks
    when given (tests feed the JAX package's own); neither is modified."""

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

    def signature(self) -> tuple:
        """Requests with equal signatures run as one batched GA."""
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {self.backend!r}")
        if self.objective not in OBJECTIVE_INDEX:
            raise ValueError(
                f"objective must be one of {tuple(OBJECTIVE_INDEX)}, "
                f"got {self.objective!r}")
        return (self.backend, int(self.pop_size), int(self.generations), self.tech)


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(x, np.float32), device=device)


# ----------------------------------------------------------------- engine
class SearchEngine:
    """Runs groups of requests as batched GAs on one device, at most
    ``MAX_SLOTS`` searches per batch.  ``launches`` counts batched GA runs
    since construction."""

    def __init__(self, *, device="cuda"):
        self.device = resolve_device(device)
        self.launches = 0

    def run(self, requests: Sequence[SearchRequest]) -> List[SearchResult]:
        """Group, execute, finalize; results align with ``requests``."""
        out: List[Optional[SearchResult]] = [None] * len(requests)
        groups: Dict[tuple, List[int]] = {}
        for i, r in enumerate(requests):
            groups.setdefault(r.signature(), []).append(i)
        for idxs in groups.values():
            for lo in range(0, len(idxs), MAX_SLOTS):
                chunk = idxs[lo:lo + MAX_SLOTS]
                res = self._execute([requests[i] for i in chunk])
                for i, r in zip(chunk, res):
                    out[i] = r
        return out  # type: ignore[return-value]

    def _execute(self, reqs: List[SearchRequest]) -> List[SearchResult]:
        dev = self.device
        r0 = reqs[0]
        backend, tech = r0.backend, r0.tech
        P, G = int(r0.pop_size), int(r0.generations)
        S = len(reqs)
        W = max(r.ws.n for r in reqs)
        L = max(int(r.ws.feats.shape[1]) for r in reqs)
        feats = torch.zeros((S, W, L, 6), dtype=torch.float32, device=dev)
        mask = torch.zeros((S, W, L), dtype=torch.bool, device=dev)
        for i, r in enumerate(reqs):
            w, l = r.ws.feats.shape[:2]
            feats[i, :w, :l] = r.ws.feats.to(dev)
            mask[i, :w, :l] = r.ws.mask.to(dev)

        gens = [_slot_generators(r.seed, dev) for r in reqs]
        ctx = _eval_ctx(feats, mask, tech, backend)
        kinds = torch.tensor([OBJECTIVE_INDEX[r.objective] for r in reqs],
                             dtype=torch.int64, device=dev)
        areas = torch.tensor([r.area_constr for r in reqs],
                             dtype=torch.float32, device=dev)
        ctx = ctx + (kinds, areas)

        init = self._init_populations(reqs, gens, feats, mask)
        tot = block_layout(P, space.N_GENES).tot
        u_blocks = torch.stack([
            _as_tensor(r.u_blocks, dev) if r.u_blocks is not None
            else torch.rand((G, tot), generator=g_ga, device=dev)
            for r, (_, g_ga) in zip(reqs, gens)
        ], dim=1)  # (G, S, tot)

        self.launches += 1
        ga = run_ga_batched(_ctx_eval(tech, backend), pop_size=P,
                            generations=G, init_genomes=init, ctx=ctx,
                            u_blocks=u_blocks)
        ga_np = GAResult(*(f.cpu().numpy() for f in ga))
        return _finalize_batch(ga_np, reqs)

    def _init_populations(self, reqs, gens, feats, mask) -> torch.Tensor:
        """Provided ``init_genomes`` are copied in; the other slots run the
        batched largest-workload rejection seeder."""
        P = int(reqs[0].pop_size)
        need = [i for i, r in enumerate(reqs) if r.init_genomes is None]
        pools = [None] * len(reqs)
        if need:
            seeded = seed_population_batched(
                [gens[i][0] for i in need], feats[need], mask[need], P,
                tech=reqs[0].tech)
            for j, i in enumerate(need):
                pools[i] = seeded[j]
        for i, r in enumerate(reqs):
            if r.init_genomes is not None:
                pools[i] = _as_tensor(r.init_genomes, self.device)
        return torch.stack(pools)


_ENGINES: Dict[str, SearchEngine] = {}


def default_engine(device="cuda") -> SearchEngine:
    """Shared engine per device behind the ``core.search`` drivers."""
    dev = resolve_device(device)
    eng = _ENGINES.get(str(dev))
    if eng is None:
        eng = _ENGINES[str(dev)] = SearchEngine(device=dev)
    return eng
