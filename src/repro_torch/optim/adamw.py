"""AdamW, the cosine schedule and global-norm clipping (the port's
``src/repro/optim/adamw.py``).

The state mirrors the parameter tree: ``mu`` and ``nu`` are float32 trees of
the parameters' structure.  The arithmetic follows the JAX package's order
of operations and rounding: the bias corrections and the schedule are
float32 tensors on the parameters' device (never Python floats), and each
leaf takes ``delta = mh / (sqrt(vh) + eps) + wd * p``, then ``p - lr * delta``
(``torch.optim.AdamW`` decays before the update, which rounds otherwise).
``adamw_update`` works in place, under ``torch.no_grad()``: the JAX launcher
donates the parameters and the state, so nothing reads the old values.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.common import tree_flatten, tree_leaves, tree_unflatten

PyTree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 0-d
    mu: PyTree  # first moment
    nu: PyTree  # second moment


def adamw_init(params: PyTree) -> AdamWState:
    leaves, treedef = tree_flatten(params)

    def zeros():
        # zeros_like: a DTensor parameter's moments take its placements
        return tree_unflatten(treedef, [torch.zeros_like(p, dtype=torch.float32,
                                                         requires_grad=False)
                                        for p in leaves])

    dev = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), mu=zeros(),
                      nu=zeros())


def cosine_schedule(step: torch.Tensor, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``min_ratio`` of
    it at ``total_steps``; a float32 0-d tensor on ``step``'s device."""
    step = torch.as_tensor(step).float()
    warm = step / max(warmup_steps, 1)
    frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return peak_lr * torch.where(step < warmup_steps, warm, cos)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, summed leaf by
    leaf in the tree's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), the norm before clipping)."""
    g = global_norm(grads)
    scale = torch.clamp_max(max_norm / torch.clamp_min(g, 1e-9), 1.0)
    leaves, treedef = tree_flatten(grads)
    return tree_unflatten(treedef, [(x.float() * scale).to(x.dtype) for x in leaves]), g


@torch.no_grad()
def adamw_update(grads: PyTree, state: AdamWState, params: PyTree, *, lr: torch.Tensor,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[PyTree, AdamWState]:
    """One AdamW step with decoupled weight decay.  Updates ``params`` and
    the state's moments in place and returns them with the step count
    advanced."""
    step = state.step + 1
    t = step.float()
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    flat_g, treedef = tree_flatten(grads)
    flat_m, flat_v, flat_p = (tree_leaves(x) for x in (state.mu, state.nu, params))
    if not len(flat_g) == len(flat_m) == len(flat_v) == len(flat_p):
        raise ValueError("grads, moments and params differ in their leaves")
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        g32 = g.float()
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * torch.square(g32))
        mh = m / c1
        vh = v / c2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
