"""The search stack on a mesh of ranks: searches AND populations split.

The paper names slow optimisation as its open problem (4 h for P=40 x G=10
on 64 CPU cores with its simulator).  Here the evaluator is a tensor
program, so the batched search stack lays out over a 2-D ``(search,
population)`` mesh (``launch.mesh.make_search_mesh``), one process per
card, every rank running the same program (SPMD):

  * dim 0 of a plan (its rows: independent GAs, one per request, seed or
    workload) splits over the ``search`` axis: a rank runs the GAs of its
    own rows, and ``gather_rows`` brings every rank the whole batch;
  * each population splits over the ``pod`` / ``data`` axes: a rank scores
    its P/d designs of every local row (``split_eval``; the ``imc_eval``
    kernel or the plain cost model) and the (B_local, P) scores are
    all-gathered along those axes before selection, which every rank runs
    on the same scores with the same draws;
  * a dimension whose size does not divide its axis group (ragged B, odd
    P) stays whole: every rank runs all of it, as ``shape_spec`` says;
  * on the ``table`` backend the ``ga_gen_step`` kernel runs a whole
    generation, survival included, in one launch, so it runs replicated
    along ``data`` (each rank all P of its rows); only the initial
    evaluation splits.

Tensors stay plain local tensors and the collectives are explicit
(``all_gather`` over the mesh's axis groups; no DTensor: the kernels'
operators have no sharding rules, and sharding propagation through the
GA's sorts and gathers would add redistributions and put bit parity at
risk).  A design's score
does not depend on how many designs share its launch (the kernel's sum
order does not depend on its lanes; the plain path reduces each design on
its own), and each row draws only from its own streams, so every result
is bit for bit the ``mesh=None`` result.

Layout helpers (the JAX package's ``pop_axes`` ... ``shape_spec``) read a
``DeviceMesh`` or a ``MeshLayout`` (names and sizes only, the counterpart
of ``jax.sharding.AbstractMesh``).  A spec is a tuple with one entry per
dimension: a tuple of axis names, or ``None`` (whole on every rank).

Collectives count their calls and the bytes they bring in (``STATS``).
Groups use NCCL on ``cuda`` and gloo on ``cpu``; gloo also takes the CUDA
tensors of ranks sharing one card.
"""
from __future__ import annotations

import dataclasses
import math
import pickle
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import space
from repro_torch.core.ga import GAResult, run_ga_batched
from repro_torch.core.objectives import make_objective
from repro_torch.imc.cost import evaluate_designs_arrays
from repro_torch.imc.tech import TECH, TechParams
from repro_torch.workloads.pack import WorkloadSet

SEARCH_AXIS = "search"
POP_AXES = ("pod", "data")

Spec = Tuple[Optional[Tuple[str, ...]], ...]


class MeshLayout(NamedTuple):
    """A mesh's axis names and sizes, with no ranks behind them."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]


def _sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, MeshLayout):
        return dict(zip(mesh.names, (int(s) for s in mesh.sizes)))
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


# ------------------------------------------------------------- axis helpers
def pop_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the population dimension splits over (may be empty)."""
    names = _sizes(mesh)
    return tuple(a for a in POP_AXES if a in names)


def search_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the search batch dimension splits over (may be empty)."""
    return tuple(a for a in (SEARCH_AXIS,) if a in _sizes(mesh))


def batch_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """``(search_axes, pop_axes)``: disjoint, and only axes of the mesh."""
    return search_axes(mesh), pop_axes(mesh)


def batch_spec(mesh, ndim: int, pop_dim: Optional[int] = None) -> Spec:
    """Dim 0 over ``search``, optional ``pop_dim`` over ``pod``/``data``,
    every other dim whole; a missing axis group gives ``None``."""
    s_ax, p_ax = batch_axes(mesh)
    parts: list = [s_ax or None] + [None] * (ndim - 1)
    if pop_dim is not None and p_ax and 0 < pop_dim < ndim:
        parts[pop_dim] = p_ax
    return tuple(parts)


def _group_size(mesh, names: Sequence[str]) -> int:
    sizes = _sizes(mesh)
    return int(math.prod(sizes[a] for a in names))


def shape_spec(mesh, shape: Sequence[int], pop_dim: Optional[int] = None) -> Spec:
    """``batch_spec`` against a concrete shape: a dimension whose size the
    product of its axes does not divide stays whole (odd populations, B
    not a multiple of the search axis).  Only parallelism changes."""
    spec = batch_spec(mesh, len(shape), pop_dim)
    return tuple(part if part is not None and int(shape[d]) % _group_size(mesh, part) == 0
                 else None for d, part in enumerate(spec))


# ------------------------------------------------------- this rank's share
def _index(mesh, names: Sequence[str]) -> int:
    """This rank's row-major index over the axes ``names``."""
    sizes = _sizes(mesh)
    idx = 0
    for a in names:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def _part(mesh, names: Optional[Tuple[str, ...]], n: int) -> slice:
    if names is None:
        return slice(0, n)
    k = n // _group_size(mesh, names)
    i = _index(mesh, names)
    return slice(i * k, (i + 1) * k)


def search_rows(mesh, n: int) -> slice:
    """The rows of a batch of ``n`` that this rank runs: its share along
    ``search``, or all ``n`` when they do not split evenly."""
    return _part(mesh, shape_spec(mesh, (n,))[0], n)


def rows_split(mesh, n: int) -> bool:
    """Whether a batch of ``n`` rows splits over the ranks (else every rank
    runs all of it)."""
    return shape_spec(mesh, (n,))[0] is not None and _group_size(mesh, search_axes(mesh)) > 1


def place_batched(mesh, x: torch.Tensor, *, pop_dim: Optional[int] = None) -> torch.Tensor:
    """This rank's part of a batched tensor: its rows of dim 0 and, with
    ``pop_dim``, its part of the population (``shape_spec``)."""
    spec = shape_spec(mesh, x.shape, pop_dim)
    idx = tuple(_part(mesh, part, int(x.shape[d])) for d, part in enumerate(spec))
    return x[idx]


def gather_batched(mesh, x: torch.Tensor, shape: Sequence[int], *,
                   pop_dim: Optional[int] = None) -> torch.Tensor:
    """``place_batched``'s inverse: the whole tensor of ``shape`` on every
    rank, all-gathered along each split dimension."""
    spec = shape_spec(mesh, shape, pop_dim)
    for d, part in enumerate(spec):
        if part is not None:
            x = _gather_axes(mesh, x, part, d)
    return x


def gather_rows(mesh, x: torch.Tensor, n: int) -> torch.Tensor:
    """A tensor of this rank's rows (dim 0) of a batch of ``n``, whole."""
    return gather_batched(mesh, x, (n,) + tuple(x.shape[1:]))


def gather_rows_dim(mesh, x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``gather_rows`` for a tensor whose rows lie along ``dim``."""
    return gather_rows(mesh, x.movedim(dim, 0), n).movedim(0, dim)


# ------------------------------------------------------------ collectives
@dataclasses.dataclass
class CollectiveStats:
    """Collective calls this process made and the bytes they brought in
    (an all-gather's whole output, a broadcast's payload)."""

    calls: int = 0
    bytes: int = 0

    def reset(self) -> None:
        self.calls = self.bytes = 0


STATS = CollectiveStats()


def _gather_axes(mesh, x: torch.Tensor, names: Tuple[str, ...], dim: int) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over the axes ``names`` (row-major:
    the last axis varies fastest, so gather it first)."""
    for a in reversed(names):
        x = all_gather_cat(x, mesh.get_group(a), dim)
    return x


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every member's ``x`` (equal shapes) along ``dim``, in
    group-rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    flag = x.dtype == torch.bool
    src = (x.to(torch.uint8) if flag else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    STATS.calls += 1
    STATS.bytes += src.numel() * src.element_size() * n
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if flag else out


def _comm_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _broadcast_bytes(obj, src: int, group) -> Any:
    """``obj`` pickled on the rank ``src`` (a global rank), sent to every
    member of ``group``: its length, then its bytes."""
    dev = _comm_device(group)
    me = dist.get_rank()
    if me == src:
        raw = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
        size = torch.tensor([raw.size], dtype=torch.int64, device=dev)
    else:
        size = torch.zeros(1, dtype=torch.int64, device=dev)
    dist.broadcast(size, src=src, group=group)
    n = int(size.item())
    if me == src:
        buf = torch.from_numpy(raw.copy()).to(dev)
    else:
        buf = torch.empty(n, dtype=torch.uint8, device=dev)
    dist.broadcast(buf, src=src, group=group)
    STATS.calls += 2
    STATS.bytes += 8 + n
    return obj if me == src else pickle.loads(buf.cpu().numpy().tobytes())


def broadcast_object(mesh, obj=None) -> Any:
    """``obj`` of the mesh's first rank (every coordinate 0: the lead),
    returned on every rank of the mesh.  Axis by axis: after step d every
    rank whose coordinates past d are 0 holds it."""
    coord = list(mesh.get_coordinate())
    grid = mesh.mesh
    for d in range(grid.dim()):
        if grid.shape[d] == 1 or any(coord[d + 1:]):
            continue
        at = list(coord)
        at[d] = 0
        obj = _broadcast_bytes(obj, int(grid[tuple(at)]), mesh.get_group(d))
    return obj


def is_lead(mesh) -> bool:
    """True on the mesh's first rank, which owns the results, the result
    cache, the checkpoints and a service's plans."""
    return mesh is None or not any(mesh.get_coordinate())


def check_device(mesh, device: torch.device) -> None:
    """Raise unless ``device`` is this rank's card of the mesh (the current
    CUDA device, which the entry point set to ``cuda:LOCAL_RANK``) or the
    CPU of a CPU mesh."""
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"mesh must be a torch DeviceMesh (launch.mesh), got {mesh!r}")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh}")
    dev = torch.device(device)
    if dev.type != mesh.device_type:
        raise ValueError(f"an engine on {dev} cannot run on a {mesh.device_type!r} mesh")
    if dev.type == "cuda":
        mine = torch.cuda.current_device()
        if dev.index is not None and dev.index != mine:
            raise ValueError(f"engine device {dev} is not this rank's card of the mesh "
                             f"(cuda:{mine}, rank {dist.get_rank()})")


# ------------------------------------------------------------ eval callbacks
def split_eval(eval_fn: Callable, mesh) -> Callable:
    """``eval_fn(genomes (B, P, n), ctx)`` over this rank's share of each
    population, the scores (or Pareto vectors) all-gathered along the
    population axes; a P they do not divide is scored whole.  A
    ``gen_step`` (the ``ga_gen_step`` kernel) is kept as it is: it runs
    whole generations, replicated along ``data``."""
    names = pop_axes(mesh)
    if not names or _group_size(mesh, names) == 1:
        return eval_fn

    def ev(genomes: torch.Tensor, ctx) -> torch.Tensor:
        P = int(genomes.shape[1])
        part = shape_spec(mesh, (1, P), pop_dim=1)[1]
        if part is None:
            return eval_fn(genomes, ctx)
        mine = eval_fn(genomes[:, _part(mesh, part, P)].contiguous(), ctx)
        return _gather_axes(mesh, mine, part, 1)

    if hasattr(eval_fn, "gen_step"):
        ev.gen_step = eval_fn.gen_step
    return ev


def sharded_eval_fn(mesh, ws: WorkloadSet, objective: str, area_constr: float,
                    tech: TechParams = TECH) -> Callable[[torch.Tensor], torch.Tensor]:
    """``eval_fn(genomes (P, n)) -> scores (P,)`` on the dense path with
    the population split over the mesh's ``pod``/``data`` axes; a mesh
    without them, or a P they do not divide, scores it whole."""
    obj = make_objective(objective, area_constr)

    def one(genomes: torch.Tensor, ctx) -> torch.Tensor:
        feats, mask = ws.feats.to(genomes.device), ws.mask.to(genomes.device)
        return obj(evaluate_designs_arrays(space.decode(genomes[0]), feats, mask, tech))[None]

    batched = split_eval(one, mesh)
    return lambda genomes: batched(genomes[None], None)[0]


def sharded_batched_eval_fn(mesh, objective: Optional[str], area_constr: float,
                            tech: TechParams = TECH, *,
                            backend: str = "dense") -> Callable:
    """Batched ``eval_fn(genomes (B, P, n), ctx) -> scores`` of the engine's
    callbacks (``core.engine._ctx_eval``) with the population split:
    ``objective`` is ``"indexed"`` (ctx tail ``kind (B,), area (B,)``),
    ``None`` (tail ``weights (B, 3)``), ``"pareto"`` (tail ``area (B,)``,
    (B, P, 3) vectors) or an objective kind.  The batch axis is the
    caller's: pass this rank's rows (``place_batched``)."""
    from repro_torch.core.engine import INDEXED, WEIGHTED, _ctx_eval

    tail = WEIGHTED if objective is None else objective
    area = float(area_constr) if tail != INDEXED else 0.0
    return split_eval(_ctx_eval(tech, backend, tail, area), mesh)


# ------------------------------------------------------------ batched drivers
def sharded_run_ga_batched(mesh, eval_fn: Callable, *, init_genomes: torch.Tensor,
                           ctx: Any = None, u_blocks: Optional[torch.Tensor] = None,
                           generators: Optional[Sequence[torch.Generator]] = None,
                           **kw) -> GAResult:
    """``core.ga.run_ga_batched`` on the mesh: this rank runs its rows (of
    ``init_genomes``, every ``ctx`` leaf, ``u_blocks`` (G, B, tot) and
    ``generators``) with the population split, and every rank returns the
    whole batch's result, bit for bit the meshless one."""
    B = int(init_genomes.shape[0])
    rows = search_rows(mesh, B)
    if ctx is not None:
        ctx = _map_rows(ctx, rows)
    res = run_ga_batched(
        split_eval(eval_fn, mesh), init_genomes=init_genomes[rows], ctx=ctx,
        u_blocks=None if u_blocks is None else u_blocks[:, rows],
        generators=None if generators is None else list(generators)[rows], **kw)
    return GAResult(*(gather_rows(mesh, f, B) for f in res))


def _map_rows(tree, rows: slice):
    if isinstance(tree, torch.Tensor):
        return tree[rows]
    if isinstance(tree, tuple):
        vals = [_map_rows(t, rows) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def sharded_batched_search(mesh, seeds, feats, mask, **kw):
    """``core.search.batched_search`` on a (search, population) mesh."""
    from repro_torch.core import search

    return search.batched_search(seeds, feats, mask, mesh=mesh, **kw)


def sharded_separate_search(mesh, seed: int, ws: WorkloadSet, **kw):
    """``core.search.separate_search`` with the W per-workload GAs split
    over the ``search`` axis."""
    from repro_torch.core import search

    return search.separate_search(seed, ws, mesh=mesh, **kw)


def sharded_seed_population_batched(mesh, source, feats, mask, pop_size: int, **kw):
    """``core.search.seed_population_batched`` on a (search, population) mesh."""
    from repro_torch.core import search

    return search.seed_population_batched(source, feats, mask, pop_size, mesh=mesh, **kw)


def sharded_search_engine(mesh, **kw):
    """A ``core.engine.SearchEngine`` whose every plan runs on this mesh:
    the DSE service stack (``serve.dse.DSEService(mesh=...)``) on many
    cards, bit for bit the meshless engine."""
    from repro_torch.core.engine import SearchEngine

    return SearchEngine(mesh=mesh, **kw)
