"""Mixture-of-Experts FFN with capacity-based dispatch, GShard-style (the
port's ``src/repro/models/moe.py``).

Each (token, k) entry takes a slot in its expert's queue of capacity
``C = ceil(S * topk * capacity_factor / E)``, in (token, k) order; entries
past the capacity are dropped.  The kept entries are written into a
``(B, E, C, d)`` buffer, the experts run as batched products over stacked
weights ``(E, d, f)``, and the results are gathered back and weighted.
The JAX package's sharding hints (``constrain``) do nothing on one device
and are left out.  The module holds no kernel: the JAX package leaves
these products to XLA, and the port to cuBLAS.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

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
    B, S, _ = x.shape
    E = router.shape[-1]
    C = moe_capacity(S, E, topk, capacity_factor)
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[..., :topk], topi[..., :topk]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    # position of each (token, k) entry within its expert queue, in
    # (token, k) order: the entries routed to the same expert before it
    onehot = torch.nn.functional.one_hot(topi.reshape(B, S * topk), E)  # (B, S*k, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = (before * onehot).sum(-1)
    return Routing(probs, topi, topw, pos, pos < C, C)


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
    B, S, d = x.shape
    E = router.shape[-1]
    r = moe_route(x, router, topk=topk, capacity_factor=capacity_factor)
    C = r.capacity
    eid = r.topi.reshape(B, S * topk)
    w = r.topw.reshape(B, S * topk)

    # dispatch: each kept entry to its own row of (B, E, C); dropped entries
    # all go to one spare row past the end, which is never read.  Kept rows
    # are unique, so the write needs no accumulation.
    rows = (torch.arange(B, device=x.device)[:, None] * E + eid) * C + r.pos
    rows = torch.where(r.keep, rows, B * E * C)
    buf = x.new_zeros((B * E * C + 1, d))
    buf[rows.reshape(-1)] = x.repeat_interleave(topk, dim=1).reshape(-1, d)
    # expert FFN batched over E: (E, B*C, d) x (E, d, f)
    xe = buf[:-1].view(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    g = torch.bmm(xe, w_gate.to(x.dtype))
    u = torch.bmm(xe, w_up.to(x.dtype))
    y = torch.bmm(glu_act(act, g, u), w_down.to(x.dtype))  # (E, B*C, d)

    # combine: gather each entry's row back (a dropped entry reads slot
    # C - 1 and is weighted 0, as in the JAX package) and weight it
    y = y.view(E, B, C, d).transpose(0, 1).reshape(B * E * C, d)
    pos_c = torch.where(r.keep, r.pos, C - 1)
    yk = y[((torch.arange(B, device=x.device)[:, None] * E + eid) * C + pos_c).reshape(-1)]
    yk = yk.view(B, S * topk, d) * (w * r.keep).to(y.dtype)[..., None]
    out = yk.view(B, S, topk, d).sum(dim=2)
    if not with_aux:
        return out, None

    # Switch-style load-balance aux: E * sum_e f_e * P_e
    f_e = torch.nn.functional.one_hot(r.topi, E).float().mean(dim=(0, 1, 2)) * topk
    p_e = r.probs.mean(dim=(0, 1))
    aux = E * torch.sum(f_e * p_e)
    return out, aux
