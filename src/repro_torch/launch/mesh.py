"""Meshes of ranks (the port's ``src/repro/launch/mesh.py``).

The port runs SPMD: one process per card, every rank the same program with
the same arguments (``torchrun --nproc-per-node N``).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over ranks ``0 ..
prod(shape) - 1`` of the default process group, with named axes:

  * ``search`` - whole searches: the leading batch axis of a plan (one row
    per independent GA) splits over it (``core.distributed``);
  * ``pod``    - the slow axis between pods (multi-pod only);
  * ``data``   - the population of each GA splits over it;
  * ``model``  - tensor / expert parallelism of the LM side.

Every constructor is collective: each rank of the world calls it, in the
same order, since it makes the process groups of every axis with
``dist.new_group``, each with a ``timeout`` (``TIMEOUT_S`` unless given),
so a collective that one rank never reaches fails the run instead of
hanging it.  A rank that the mesh leaves out gets ``None``.

Axis sizes clamp to the world size as the JAX constructors clamp to
``jax.devices()`` (``_fit_axis``; the shapes alone come from
``fit_test_mesh`` / ``fit_search_mesh``), so a run sized for 8 cards
degrades to 1x1 in a world of one.  ``make_mesh`` and
``make_production_mesh`` raise on a world that is too small, as
``jax.make_mesh`` does.

``init_world`` is for entry points only (the CLI, ``chip_smoke.py``): it
makes the default process group from torchrun's ``RANK`` / ``WORLD_SIZE``
/ ``LOCAL_RANK`` (``MASTER_ADDR`` / ``MASTER_PORT``), or a world of one
when they are not set, and puts the rank on ``cuda:LOCAL_RANK``.  Library
functions take a mesh and never make a group.  ``fake_world`` makes a
default group of ``n`` ranks with no ranks behind it (the ``fake``
backend): this process is its rank 0, and every collective returns at once
without moving data, so a step traced under ``FakeTensorMode`` on a
production mesh runs on one host (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

TIMEOUT_S = 120.0


def init_world(device: str = "cuda", *,
               backend: Optional[str] = None) -> Tuple[int, int, torch.device]:
    """Make the default process group if there is none: from torchrun's
    variables, or a world of one (an in-process store) when ``RANK`` is
    not set, its groups timing out after ``TIMEOUT_S``.  ``backend``
    defaults to NCCL on ``cuda`` and gloo on ``cpu`` (gloo also runs ranks
    that share one card).  Returns ``(rank, world,
    device)`` with ``device`` this rank's card, ``cuda:LOCAL_RANK``, made
    current, or the CPU."""
    dev_type = torch.device(device).type
    if dev_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_world('cuda') but torch.cuda.is_available() is False; "
                           "pass device='cpu' for a gloo world on the CPU")
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda", local) if dev_type == "cuda" else torch.device("cpu")
    if dev_type == "cuda":
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} but {torch.cuda.device_count()} "
                               "cards are visible")
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        timeout = datetime.timedelta(seconds=TIMEOUT_S)
        if "RANK" in os.environ:
            dist.init_process_group(backend, init_method="env://", timeout=timeout,
                                    rank=int(os.environ["RANK"]),
                                    world_size=int(os.environ["WORLD_SIZE"]))
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=timeout)
    return dist.get_rank(), dist.get_world_size(), dev


@contextlib.contextmanager
def fake_world(n: int, device_type: str = "cuda"):
    """A ``fake`` default process group of ``n`` ranks (this process rank
    0, a ``FakeStore``), destroyed on exit; refuses when a default group
    already exists, so no run joins a fake world by mistake (or a test
    another's).  The group serves collectives on ``device_type`` only,
    where the (fake) tensors of the steps traced inside claim to live:
    fake tensors need no card."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group exists already")
    dist.init_process_group(f"{device_type}:fake", store=FakeStore(), rank=0,
                            world_size=int(n))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs the default process group "
                           "(launch.mesh.init_world in an entry point)")
    return dist.get_world_size()


def _fit_axis(requested: int, remaining: int) -> int:
    """Axis size clamped to the remaining rank budget, the degradation
    rule shared by every constructor."""
    return max(1, min(int(requested), remaining))


def fit_test_mesh(world: int, data: int = 1, model: int = 1,
                  search: int = 1) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``make_test_mesh``'s (shape, axes) in a world of ``world`` ranks:
    ``(search, data, model)`` when ``search > 1`` is asked for, else
    ``(data, model)``."""
    sizes = {}
    remaining = int(world)
    for name, req in (("search", search), ("data", data), ("model", model)):
        sizes[name] = _fit_axis(req, remaining)
        remaining //= sizes[name]
    if search > 1:
        return (sizes["search"], sizes["data"], sizes["model"]), ("search", "data", "model")
    return (sizes["data"], sizes["model"]), ("data", "model")


def fit_search_mesh(world: int, searches: Optional[int] = None,
                    pop: Optional[int] = None) -> Tuple[int, int]:
    """``make_search_mesh``'s (searches, pop) in a world of ``world``
    ranks: all ranks on ``search`` by default, sizes clamped."""
    n = int(world)
    if searches is None and pop is None:
        return n, 1
    if searches is None:
        pop = _fit_axis(pop, n)
        return n // pop, pop
    if pop is None:
        searches = _fit_axis(searches, n)
        return searches, n // searches
    searches = _fit_axis(searches, n)
    return searches, _fit_axis(pop, n // searches)


def _build(shape: Sequence[int], axes: Sequence[str], device_type: str,
           timeout_s: float) -> Optional[DeviceMesh]:
    """The mesh over ranks ``0 .. prod(shape) - 1``, row-major, with one
    process group per line of each axis, each made with the timeout.  Every
    rank of the world makes every group, in the same order."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    grid = torch.arange(math.prod(shape), dtype=torch.int64).reshape(shape)
    me = dist.get_rank()
    timeout = datetime.timedelta(seconds=float(timeout_s))
    mine = []
    for d in range(len(shape)):
        lines = grid.movedim(d, -1).reshape(-1, shape[d])
        own = None
        for line in lines.tolist():
            g = dist.new_group(ranks=line, timeout=timeout)
            if me in line:
                own = g
        mine.append(own)
    if me >= grid.numel():
        return None
    return DeviceMesh.from_group(mine, device_type, mesh=grid,
                                 mesh_dim_names=axes)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device_type: str = "cuda", timeout_s: float = TIMEOUT_S
              ) -> Optional[DeviceMesh]:
    """An arbitrary mesh over the first ``prod(shape)`` ranks; raises when
    the world is smaller, as ``jax.make_mesh`` does."""
    n = _world()
    if math.prod(shape) > n:
        raise ValueError(f"world of {n} ranks must be >= the product of mesh shape "
                         f"{tuple(shape)}")
    return _build(shape, axes, device_type, timeout_s)


def make_production_mesh(*, multi_pod: bool = False, searches: int = 1,
                         device_type: str = "cuda", timeout_s: float = TIMEOUT_S
                         ) -> Optional[DeviceMesh]:
    """16x16 pod (or 2x16x16 multi-pod) mesh; ``searches > 1`` prepends a
    ``search`` axis.  Raises on a world smaller than the mesh."""
    shape: Tuple[int, ...] = (2, 16, 16) if multi_pod else (16, 16)
    axes: Tuple[str, ...] = ("pod", "data", "model") if multi_pod else ("data", "model")
    if searches > 1:
        shape, axes = (searches,) + shape, ("search",) + axes
    return make_mesh(shape, axes, device_type=device_type, timeout_s=timeout_s)


def make_test_mesh(data: int = 1, model: int = 1, search: int = 1, *,
                   device_type: str = "cuda", timeout_s: float = TIMEOUT_S
                   ) -> Optional[DeviceMesh]:
    """A small mesh over the ranks present, sizes clamped to the world
    (``fit_test_mesh``)."""
    shape, axes = fit_test_mesh(_world(), data, model, search)
    return _build(shape, axes, device_type, timeout_s)


def make_search_mesh(searches: Optional[int] = None, pop: Optional[int] = None, *,
                     device_type: str = "cuda", timeout_s: float = TIMEOUT_S
                     ) -> Optional[DeviceMesh]:
    """2-D ``(search, data)`` mesh for the sharded search stack: ``searches``
    splits the independent GAs, ``pop`` each GA's population; all ranks on
    ``search`` by default, sizes clamped to the world
    (``fit_search_mesh``)."""
    shape = fit_search_mesh(_world(), searches, pop)
    return _build(shape, ("search", "data"), device_type, timeout_s)


def barrier(mesh) -> None:
    """Wait until every rank of ``mesh`` got here: a one-element all-reduce
    along each axis in turn (after the last one, every rank's sum holds
    every rank's term)."""
    for d in range(mesh.ndim):
        group = mesh.get_group(d)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend(group) == "nccl" else torch.device("cpu"))
        dist.all_reduce(torch.ones(1, device=dev), group=group)


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis_name: size}`` in mesh order, of a ``DeviceMesh`` or of a
    layout with no ranks behind it (``core.distributed.MeshLayout``)."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.names, (int(s) for s in mesh.sizes)))


def describe(mesh) -> str:
    return "x".join(f"{a}={s}" for a, s in mesh_axis_sizes(mesh).items())
