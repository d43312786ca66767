"""Logical sharding context (the port's ``src/repro/distributed/ctx.py``).

Launchers enter ``use_rules(mesh, rules)``; model code calls
``constrain(x, ("batch", "experts", None, None))``.  Outside any context
(one device, the serving path) ``constrain`` returns its argument itself,
so the model stays the meshless one.  Inside a context it redistributes a
``DTensor`` to the layout the logical names give on the context's
``DeviceMesh``: where the JAX package hands GSPMD a sharding constraint,
the port moves the data (``DTensor.redistribute``) there and then.  A plain
tensor passes through: on a mesh it is a rank's local part of a computation
the model lays out by hand (attention, the SSD, MoE dispatch).

Divisibility is checked per dim: a logical name whose dim size does not
divide the mapped mesh-axis product, or whose axis an earlier dim took,
falls back to replicated for that dim (the policy of ``param_specs``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.common import axis_size, dim_spec, flat_axes

# the active (mesh, rules), for the whole process: the autograd engine runs
# a CUDA backward, and so the recomputation of every remat'd block, on a
# thread of its own, which must lay the block out as its forward did
_STATE: list = [None]

Spec = Tuple[Any, ...]


def _current() -> Optional[Tuple[Any, Dict[str, Any]]]:
    return _STATE[0]


@contextlib.contextmanager
def use_rules(mesh, rules: Dict[str, Any]):
    """rules: logical name -> mesh axis (str | tuple | None).  The context
    holds for every thread of the process until it exits."""
    prev = _current()
    _STATE[0] = (mesh, rules)
    try:
        yield
    finally:
        _STATE[0] = prev


def _sizes(mesh) -> Dict[str, int]:
    from repro_torch.launch.mesh import mesh_axis_sizes

    return mesh_axis_sizes(mesh)


def axis_product(mesh, ax: Any) -> int:
    return axis_size(_sizes(mesh), ax)


def logical_axis_size(name: str) -> int:
    """Mesh-axis product a logical name maps to (1 when no context)."""
    ctx = _current()
    if ctx is None:
        return 1
    mesh, rules = ctx
    return axis_product(mesh, rules.get(name))


def logical_spec(mesh, rules: Dict[str, Any], shape: Sequence[int],
                 logical: Sequence[Optional[str]]) -> Spec:
    """The spec ``constrain`` gives a tensor of ``shape``: each dim's axes,
    or None where the name maps to nothing, does not divide, or reuses an
    axis (``common.dim_spec``, the rule of ``param_specs``)."""
    assert len(logical) == len(shape), (logical, tuple(shape))
    return dim_spec(shape, logical, rules, _sizes(mesh))[0]


def placements(mesh, spec: Spec) -> tuple:
    """DTensor placements of a spec on ``mesh``: per mesh dim, ``Shard(d)``
    for the tensor dim ``d`` whose spec entry names it, else
    ``Replicate()``.  A dim over several axes is split in mesh order, as
    jax splits ``P(("pod", "data"))``."""
    names = tuple(_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in flat_axes(entry):
            if a in names:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def local_shard(full: torch.Tensor, mesh, places: Sequence) -> torch.Tensor:
    """This rank's shard of ``full`` (the same value on every rank) under
    ``places``: no communication."""
    coord = mesh.get_coordinate()
    x = full
    for md, p in enumerate(places):
        if isinstance(p, Shard):
            x = torch.chunk(x, mesh.size(md), dim=p.dim)[coord[md]]
    return x


def distribute(full: torch.Tensor, mesh, places: Sequence) -> DTensor:
    """A DTensor of ``full`` (the same value on every rank), each rank
    keeping its own shard, a copy (a view would keep all of ``full``
    alive): no communication."""
    local = local_shard(full, mesh, places)
    local = local.clone(memory_format=torch.contiguous_format) if (
        local.numel() != full.numel()) else local.contiguous()
    return DTensor.from_local(local, mesh, tuple(places), run_check=False)


def batch_rows(x: DTensor) -> list:
    """Placements that keep x's batch (dim 0) split where it is and make
    every other dim whole: each rank then holds whole sequences."""
    return [p if p == Shard(0) else Replicate() for p in x.placements]


def whole(w: DTensor, rows: Sequence) -> torch.Tensor:
    """``w`` whole on every rank, as a local tensor for a computation on
    each rank's own sequences (``rows``, from ``batch_rows``): its gradient
    is the sum over the ranks that split the batch, and the same on the
    ranks that computed alike."""
    mesh = w.device_mesh
    grad = [Partial() if p == Shard(0) else Replicate() for p in rows]
    return w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grad)


def local_rows(c: DTensor, dim: int) -> Tuple[torch.Tensor, int, list]:
    """(this rank's local tensor of ``c``, the global index of its first
    row along ``dim``, the mesh dims that split ``dim``): a dim split over
    several mesh dims is split in mesh order, as ``placements`` lays it."""
    mesh = c.device_mesh
    split = [i for i, p in enumerate(c.placements) if p == Shard(dim)]
    idx = 0
    for i in split:
        idx = idx * mesh.size(i) + mesh.get_coordinate()[i]
    local = c.to_local()
    return local, idx * local.shape[dim], split


def all_reduce_over(mesh, dims: Sequence[int]):
    """``f(t, op)``: ``t`` reduced ("max" / "sum") over the ranks of mesh
    ``dims``, one functional all-reduce per dim of more than one rank;
    ``t`` itself for none."""
    import torch.distributed._functional_collectives as funcol

    def f(t: torch.Tensor, op: str) -> torch.Tensor:
        for i in dims:
            if mesh.size(i) > 1:
                t = funcol.all_reduce(t, op, mesh.get_group(i))
        return t
    return f


def constrain(x: torch.Tensor, logical: Sequence[Optional[str]]) -> torch.Tensor:
    """Redistribute a DTensor to the logical layout when a context is
    active; otherwise, or for a plain tensor (a rank's local part of a
    computation laid out by hand), return ``x`` itself."""
    ctx = _current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    want = placements(x.device_mesh, logical_spec(mesh, rules, x.shape, logical))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(-1, -2)


def _mm(a: torch.Tensor, b: torch.Tensor, batched: bool) -> torch.Tensor:
    return torch.bmm(a, b) if batched else torch.matmul(a, b)


def mm32(a: torch.Tensor, b: torch.Tensor, batched: bool = False) -> torch.Tensor:
    """``a @ b`` (a bmm when ``batched``) with a float32 result, as the JAX
    package's ``preferred_element_type=float32``: the products of bf16
    values are exact in float32 and summed in float32.  On the card two
    bf16 operands go through ``out_dtype=`` (tensor cores, float32
    accumulation); elsewhere, or for mixed dtypes, a float32 product of the
    widened operands."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype in (torch.bfloat16, torch.float16):
        if batched:
            return torch.bmm(a, b, out_dtype=torch.float32)
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.view(a.shape[:-1] + (b.shape[-1],))
    return _mm(a.float(), b.float(), batched)


class _F32Logits(torch.autograd.Function):
    """``h @ w`` of two bf16 matrices with a float32 result (``mm32``).  The
    backward pass contracts the float32 gradient with the other operand
    widened to float32 and rounds the result to the operand's dtype, as
    JAX's transpose of that product does."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return mm32(h, w)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        gh = gw = None
        if ctx.needs_input_grad[0]:
            gh = (g @ w.float().T).to(h.dtype)
        if ctx.needs_input_grad[1]:
            gw = (h.float().T @ g).to(w.dtype)
        return gh, gw


def _w_grad(x: torch.Tensor, g: torch.Tensor, batched: bool, f32: bool) -> torch.Tensor:
    """``x^T g``, the weight's gradient of ``x @ w``: rows of x folded for a
    matmul, per expert for a bmm (as autograd computes it); in float32
    (``mm32``) when ``f32``."""
    if batched:
        return (mm32 if f32 else _mm)(_t(x), g, True)
    x2, g2 = x.reshape(-1, x.shape[-1]).T, g.reshape(-1, g.shape[-1])
    return mm32(x2, g2) if f32 else x2.mm(g2)


class _Project(torch.autograd.Function):
    """``x @ w`` (or a bmm over experts) of DTensors, each rank multiplying
    its shards, laid out per mesh dim by the weight's split (Megatron):

    * the contraction split (row parallel): x split alike; each rank's
      partial product is summed across the ranks;
    * the columns split (column parallel): x whole on that dim (its
      sequence gathered); backward, x's gradient is the sum of each rank's
      partial product;
    * the experts split (a bmm's batch): x split alike;
    * the weight whole: x's split (batch or sequence) passes through, and
      the weight's gradient is a sum over those ranks.

    Every product a rank computes is the meshless product restricted to its
    shard, in the meshless dtype, except those summed across ranks: their
    bf16 operands give a float32 product (``mm32``), summed in float32 and
    rounded once.  With ``out32`` the result stays float32 (the head's
    logits) and both gradients come from float32 products, rounded to their
    operand's dtype, as ``_F32Logits``.  DTensor's own rules for a matmul
    never run (torch 2.11's cannot flatten (B, S) with S split)."""

    @staticmethod
    def forward(ctx, x, w, batched, out32):
        mesh, kx = x.device_mesh, x.ndim - 1
        wk, wn = (1, 2) if batched else (0, 1)
        xp, wp, yp, kinds = [], [], [], []
        for px, pw in zip(x.placements, w.placements):
            if pw == Shard(wk) or px == Shard(kx):
                kind, a, b, c = "row", Shard(kx), Shard(wk), Replicate()
            elif pw == Shard(wn):
                kind, a, b, c = "col", Replicate(), Shard(wn), Shard(x.ndim - 1)
            elif batched and pw == Shard(0):
                kind, a, b, c = "expert", Shard(0), Shard(0), Shard(0)
            else:
                a = px if isinstance(px, Shard) else Replicate()
                kind, b, c = "whole", Replicate(), a
            kinds.append(kind)
            xp.append(a)
            wp.append(b)
            yp.append(c)
        ctx.orig = (tuple(x.placements), tuple(w.placements), x.dtype, w.dtype)
        x, w = x.redistribute(mesh, xp), w.redistribute(mesh, wp)
        ctx.save_for_backward(x, w)
        ctx.kinds, ctx.yp, ctx.batched, ctx.out32 = kinds, yp, batched, out32
        xl, wl = x.to_local(), w.to_local()
        if "row" in kinds:
            part = [Partial() if k == "row" else p for k, p in zip(kinds, yp)]
            y = DTensor.from_local(mm32(xl, wl, batched), mesh, part,
                                   run_check=False).redistribute(mesh, yp)
            return y if out32 else y.to(x.dtype)
        y = mm32(xl, wl, batched) if out32 else _mm(xl, wl, batched)
        return DTensor.from_local(y, mesh, yp, run_check=False)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mesh, kinds, batched, out32 = x.device_mesh, ctx.kinds, ctx.batched, ctx.out32
        orig_x, orig_w, x_dtype, w_dtype = ctx.orig
        gl = g.redistribute(mesh, ctx.yp).to_local()
        xl, wl = x.to_local(), w.to_local()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            # a column split leaves each rank a partial sum of x's gradient
            part = [Partial() if k == "col" else p for k, p in zip(kinds, x.placements)]
            f32 = out32 or "col" in kinds
            gxl = mm32(gl, _t(wl), batched) if f32 else _mm(gl, _t(wl), batched)
            gx = DTensor.from_local(gxl, mesh, part, run_check=False)
            gx = gx.redistribute(mesh, orig_x).to(x_dtype)
        if ctx.needs_input_grad[1]:
            # a sum over the ranks that split x's rows (not a bmm's experts)
            summed = [k == "whole" and isinstance(p, Shard) and not (batched and p.dim == 0)
                      for k, p in zip(kinds, x.placements)]
            part = [Partial() if s_ else p for s_, p in zip(summed, w.placements)]
            gw = DTensor.from_local(_w_grad(xl, gl, batched, out32 or any(summed)), mesh, part,
                                    run_check=False)
            gw = gw.redistribute(mesh, orig_w).to(w_dtype)
        return gx, gw, None, None


def project(x: torch.Tensor, w: torch.Tensor, op=torch.matmul, *,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``op(x, w)`` of an activation and a weight (``torch.matmul``, or
    ``torch.bmm`` for the experts): for a DTensor weight each rank
    multiplies its shards (``_Project``), off a mesh the meshless product.
    ``out_dtype=torch.float32`` keeps a float32 result of bf16 operands
    (the head's logits; a matmul of matrices only): ``_F32Logits`` off a
    mesh."""
    out32 = out_dtype == torch.float32
    if isinstance(w, DTensor):
        return _Project.apply(x, w, op is torch.bmm, out32)
    return _F32Logits.apply(x, w) if out32 else op(x, w)
