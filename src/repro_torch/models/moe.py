"""Mixture-of-Experts FFN with capacity-based dispatch, GShard-style (the
port's ``src/repro/models/moe.py``).

Each (token, k) entry takes a slot in its expert's queue of capacity
``C = ceil(S * topk * capacity_factor / E)``, in (token, k) order; entries
past the capacity are dropped.  The kept entries are written into a
``(B, E, C, d)`` buffer, the experts run as batched products over stacked
weights ``(E, d, f)``, and the results are gathered back and weighted.
On a mesh (DTensor activations, ``distributed/ctx.py``) the routing, the
dispatch and the combine run on each rank's own sequences, which they need
whole (``_moe_ffn_mesh``); the expert products run on DTensors, laid out by
the JAX package's ``constrain`` hints (the buffer's experts over ``model``
when the count divides it).  The module holds no kernel: the JAX package
leaves these products to XLA, and the port to cuBLAS.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.ctx import constrain, logical_axis_size, project
from repro_torch.models.common import glu_act


def moe_capacity(seq: int, n_experts: int, topk: int, capacity_factor: float) -> int:
    c = int(-(-seq * topk * capacity_factor // n_experts))  # ceil
    return max(1, min(c, seq * topk))


class Routing(NamedTuple):
    probs: torch.Tensor  # (B, S, E) float32 router softmax
    topi: torch.Tensor  # (B, S, k) expert of each entry, highest probability first
    topw: torch.Tensor  # (B, S, k) float32 gate weights, renormalised over k
    pos: torch.Tensor  # (B, S*k) position of entry (t, j) in its expert's queue
    keep: torch.Tensor  # (B, S*k) bool: pos < C
    capacity: int


def moe_route(x: torch.Tensor, router: torch.Tensor, *, topk: int,
              capacity_factor: float) -> Routing:
    """The router in float32, the top-k experts per token and each entry's
    queue position.  Among equal probabilities the lower expert index comes
    first, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no
    order among ties; a stable descending sort does)."""
    return _route(torch.softmax(x.float() @ router.float(), dim=-1), topk, capacity_factor)


def _route(probs: torch.Tensor, topk: int, capacity_factor: float) -> Routing:
    B, S, E = probs.shape
    C = moe_capacity(S, E, topk, capacity_factor)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :topk], topi[..., :topk]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    # position of each (token, k) entry within its expert queue, in
    # (token, k) order: the entries routed to the same expert before it
    onehot = torch.nn.functional.one_hot(topi.reshape(B, S * topk), E)  # (B, S*k, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = (before * onehot).sum(-1)
    return Routing(probs, topi, topw, pos, pos < C, C)


def _dispatch(x: torch.Tensor, r: Routing, topk: int) -> torch.Tensor:
    """(B, E, C, d): each kept entry in its own row of its expert's queue;
    dropped entries all go to one spare row past the end, which is never
    read.  Kept rows are unique, so the write needs no accumulation."""
    B, S, d = x.shape
    E, C = r.probs.shape[-1], r.capacity
    eid = r.topi.reshape(B, S * topk)
    rows = (torch.arange(B, device=x.device)[:, None] * E + eid) * C + r.pos
    rows = torch.where(r.keep, rows, B * E * C)
    buf = x.new_zeros((B * E * C + 1, d))
    buf[rows.reshape(-1)] = x.repeat_interleave(topk, dim=1).reshape(-1, d)
    return buf[:-1].view(B, E, C, d)


def _combine(y: torch.Tensor, r: Routing, topk: int) -> torch.Tensor:
    """(B, S, d): each entry's row of ``y`` (B, E, C, d) back, weighted by
    its gate (a dropped entry reads slot C - 1 and is weighted 0, as in the
    JAX package), summed over its token's k entries."""
    B, E, C, d = y.shape
    S = r.topi.shape[1]
    eid = r.topi.reshape(B, S * topk)
    w = r.topw.reshape(B, S * topk)
    pos_c = torch.where(r.keep, r.pos, C - 1)
    yk = y.reshape(B * E * C, d)[
        ((torch.arange(B, device=y.device)[:, None] * E + eid) * C + pos_c).reshape(-1)]
    yk = yk.view(B, S * topk, d) * (w * r.keep).to(y.dtype)[..., None]
    return yk.view(B, S, topk, d).sum(dim=2)


def _experts(buf: torch.Tensor, w_gate, w_up, w_down, act: str) -> torch.Tensor:
    """The expert FFN batched over E: (B, E, C, d) -> (B, E, C, d)."""
    B, E, C, d = buf.shape
    xe = buf.transpose(0, 1).reshape(E, B * C, d)
    g = project(xe, w_gate, torch.bmm)
    u = project(xe, w_up, torch.bmm)
    y = project(glu_act(act, g, u), w_down, torch.bmm)  # (E, B*C, d)
    return y.view(E, B, C, d).transpose(0, 1)


def moe_ffn(
    x: torch.Tensor,  # (B, S, d)
    router: torch.Tensor,  # (d, E)
    w_gate: torch.Tensor,  # (E, d, f)
    w_up: torch.Tensor,  # (E, d, f)
    w_down: torch.Tensor,  # (E, f, d)
    *,
    topk: int,
    capacity_factor: float,
    act: str = "silu",
    with_aux: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (output (B, S, d) in x's dtype, the aux load-balance loss, a
    float32 scalar, or None with ``with_aux=False``: decode reads no aux,
    and eager PyTorch would launch its work every step)."""
    if isinstance(x, DTensor):
        return _moe_ffn_mesh(x, router, w_gate, w_up, w_down, topk=topk,
                             capacity_factor=capacity_factor, act=act, with_aux=with_aux)
    E = router.shape[-1]
    r = moe_route(x, router, topk=topk, capacity_factor=capacity_factor)
    buf = _dispatch(x, r, topk)
    y = _experts(buf, w_gate.to(x.dtype), w_up.to(x.dtype), w_down.to(x.dtype), act)
    out = _combine(y, r, topk)
    if not with_aux:
        return out, None

    # Switch-style load-balance aux: E * sum_e f_e * P_e
    f_e = torch.nn.functional.one_hot(r.topi, E).float().mean(dim=(0, 1, 2)) * topk
    p_e = r.probs.mean(dim=(0, 1))
    aux = E * torch.sum(f_e * p_e)
    return out, aux


def _moe_ffn_mesh(x, router, w_gate, w_up, w_down, *, topk, capacity_factor, act,
                  with_aux):
    """``moe_ffn`` on DTensors.  The queue positions run over whole
    sequences, so x is first laid out by batch alone (its seq dim gathered
    over ``model``: explicit, as DTensor has no rule for the dispatch's
    index_put), and each rank routes, dispatches and combines its own
    sequences on local tensors.  The buffer and the expert outputs are
    DTensors between, the buffer's experts over ``model`` when the count
    divides it (expert parallelism: the weights' bf16 copies stay split
    by expert); the combine gathers every expert's rows back first."""
    mesh = x.device_mesh
    E = router.shape[-1]
    rows = [p if p == Shard(0) else Replicate() for p in x.placements]
    x = x.redistribute(mesh, rows)
    # the router whole on every rank: each rank's logits are then the
    # meshless run's rows, bit for bit (a contraction split over data would
    # reorder the float32 sums, and a near-tie could pick another expert)
    router = router.redistribute(mesh, [Replicate()] * mesh.ndim)
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    r = _route(probs.redistribute(mesh, rows).to_local(), topk, capacity_factor)
    buf = DTensor.from_local(_dispatch(x.to_local(), r, topk), mesh, rows, run_check=False)
    buf = constrain(buf, ("batch", "experts", None, None))
    ep_active = E % max(logical_axis_size("experts"), 1) == 0

    def compute_copy(w):
        w = w.to(x.dtype)
        return constrain(w, ("experts", None, None)) if ep_active else w

    y = _experts(buf, compute_copy(w_gate), compute_copy(w_up), compute_copy(w_down), act)
    y = constrain(y, ("batch", "experts", None, None))
    out = _combine(y.redistribute(mesh, rows).to_local(), r, topk)
    out = constrain(DTensor.from_local(out, mesh, rows, run_check=False),
                    ("batch", "seq", None))
    if not with_aux:
        return out, None
    # the Switch aux over the global batch: each rank's sums, summed
    part = [Partial() if p == Shard(0) else Replicate() for p in rows]
    B, S = x.shape[:2]
    f_sum = torch.nn.functional.one_hot(r.topi, E).float().sum(dim=(0, 1, 2))
    f_e = DTensor.from_local(f_sum, mesh, part, run_check=False) / (B * S * topk) * topk
    p_e = DTensor.from_local(r.probs.sum(dim=(0, 1)), mesh, part, run_check=False) / (B * S)
    return out, E * torch.sum(f_e * p_e)
