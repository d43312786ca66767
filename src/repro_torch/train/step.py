"""Training step: loss, gradients, clipping, AdamW (the port's
``src/repro/train/step.py``).

``make_train_step`` builds, per (config, hyperparameters), a function

    new_params, new_opt, metrics = step(params, opt_state, batch)

``params`` is the float32 master tree, every leaf with ``requires_grad``;
the model casts each weight to bf16 where it uses it, so the gradients
reach the masters (``compute_params``' cast tree has no path back to them
and is never read here).  Gradients come from ``torch.autograd.grad`` over
the leaves; the update runs in place (the JAX launcher donates both trees),
so the returned trees are the ones passed in.  With ``remat=True`` each
pass over the layer plan is recomputed in the backward pass
(``transformer.forward(remat=True)``), and each chunk of the loss too, so
activation memory is one block's and the (B, S, V) logits never exist at
once.

The step runs the plain attention and SSD (``impl="plain"``), as the JAX
package's step runs ``attn_impl="jnp"``: neither the JAX package's Pallas
kernels nor the port's CUDA kernels have a backward pass.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Tuple

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import batch_rows, constrain, project
from repro_torch.models import transformer
from repro_torch.models.common import tree_flatten, tree_unflatten
from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_schedule

PyTree = Any

NO_KERNEL_BACKWARD = (
    "training runs impl='plain': the attention and SSD kernels have no backward "
    "pass, and the JAX package's attn_impl='pallas' does not differentiate "
    "(ROADMAP.md, 'Done: training')")


def _check_impl(impl: str) -> None:
    if impl == "kernel":
        raise ValueError(NO_KERNEL_BACKWARD)
    if impl != "plain":
        raise ValueError(f"impl {impl!r}: training takes 'plain'")


def _xent_chunk(h: torch.Tensor, head_w: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Sum over one chunk of (logsumexp - gold logit), float32: the logits
    a float32 product of bf16 operands (``ctx.project``), as the JAX
    package's ``einsum(..., preferred_element_type=float32)``."""
    B, c, d = h.shape
    wc = constrain(head_w.to(h.dtype), (None, "vocab"))
    if isinstance(h, DTensor):  # no (B, c) merge: DTensor cannot view a split B of 1
        logits = project(h, wc, out_dtype=torch.float32)
    else:
        logits = project(h.reshape(B * c, d), wc, out_dtype=torch.float32).view(B, c, -1)
    logits = constrain(logits, ("batch", None, "vocab"))
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    if isinstance(logits, DTensor):
        # the JAX package's one-hot contraction: DTensor's gather across a
        # split vocab dim (a masked partial) fails in its reduction
        onehot = torch.arange(logits.shape[-1], device=t.device) == t[..., None]
        gold = torch.sum(torch.where(onehot, logits, 0.0), dim=-1)
    else:
        # the gold logit by a gather: the one-hot sum adds one logit to
        # zeros, exactly, so both give the same value and gradient
        gold = torch.gather(logits, -1, t[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_softmax_xent(hidden: torch.Tensor, head_w: torch.Tensor,
                         targets: torch.Tensor, *, chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy over (B, S) without the (B, S, V)
    logits: a loop over sequence chunks, each chunk's float32 logits
    consumed by the logsumexp (its max detached) and the gold logit, each
    chunk recomputed in the backward pass (``torch.utils.checkpoint``), so
    one chunk's logits exist at a time.

    On a mesh the head's bf16 compute copy is laid out (gathered over the
    FSDP axis) once, before the loop, and every chunk and its recomputation
    read that copy; its gradient then sums over the chunks in bf16 (off a
    mesh each chunk casts the float32 master, as the JAX package's loop
    body, and the chunks' gradients sum in float32)."""
    B, S, d = hidden.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is no multiple of the loss chunk {chunk}")
    targets = targets.long()
    if isinstance(hidden, DTensor):  # whole sequences: the chunks slice them
        hidden = hidden.redistribute(hidden.device_mesh, batch_rows(hidden))
        head_w = constrain(head_w.to(hidden.dtype), (None, "vocab"))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, S, chunk):
        total = total + torch.utils.checkpoint.checkpoint(
            _xent_chunk, hidden[:, lo:lo + chunk], head_w, targets[:, lo:lo + chunk],
            use_reentrant=False)
    return total / (B * S)


def loss_fn(cfg: ModelConfig, params: PyTree, batch: Dict[str, torch.Tensor], *,
            aux_weight: float = 0.01, remat: bool = True, impl: str = "plain",
            loss_chunk: int = 512) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross-entropy (+ the MoE load-balance aux)."""
    _check_impl(impl)
    hidden, aux = transformer.forward(
        cfg, params, batch["inputs"], vision_embeds=batch.get("vision_embeds"),
        mrope_pos=batch.get("mrope_pos"), frames=batch.get("frames"),
        impl=impl, remat=remat, return_hidden=True)
    xent = chunked_softmax_xent(hidden, transformer.head_weight(cfg, params),
                                batch["targets"], chunk=loss_chunk)
    loss = xent + aux_weight * aux
    return loss, {"xent": xent, "moe_aux": aux}


def _microbatches(batch: Dict[str, torch.Tensor], accum: int):
    """``accum`` equal slices of the batch; ``mrope_pos`` (3, B, S) is split
    on its batch axis 1.  A DTensor batch is sliced rank by rank: the
    microbatches then group other sequences than the meshless run's, and
    the averaged gradient is the same mean over the whole batch."""
    def split(name, x):
        if isinstance(x, DTensor):
            parts = split(name, x.to_local())
            return [DTensor.from_local(v, x.device_mesh, x.placements, run_check=False)
                    for v in parts]
        rows = x.shape[1 if name == "mrope_pos" else 0]
        if rows % accum:
            raise ValueError(f"a batch of {rows} rows (on this rank) does not split into "
                             f"{accum} microbatches")
        if name == "mrope_pos":
            return x.reshape(x.shape[0], accum, x.shape[1] // accum, x.shape[2]).movedim(1, 0)
        return x.reshape((accum, x.shape[0] // accum) + tuple(x.shape[1:]))

    parts = {k: split(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(accum)]


def _full(x: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor: a DTensor's whole value."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's layout: a DTensor gradient comes back
    in whatever placements the backward pass left it (a ``Partial`` sum over
    the ranks that split the batch), and is reduced to the parameter's
    shards once, here (the reduce-scatter)."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def loss_and_grads(cfg: ModelConfig, params: PyTree, batch: Dict[str, torch.Tensor], *,
                   aux_weight: float = 0.01, remat: bool = True, impl: str = "plain"
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
    """(loss, metrics, gradients) of ``loss_fn``, the gradients in the
    order of ``tree_flatten(params)``'s leaves, each in its parameter's
    placements on a mesh (``_as_param``); run under the launcher's
    ``ctx.use_rules`` there."""
    leaves = tree_flatten(params)[0]
    on_mesh = isinstance(leaves[0], DTensor)
    with implicit_replication() if on_mesh else contextlib.nullcontext():
        loss, metrics = loss_fn(cfg, params, batch, aux_weight=aux_weight, remat=remat,
                                impl=impl)
        grads = torch.autograd.grad(loss, leaves)
        grads = [_as_param(g, p) for g, p in zip(grads, leaves)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4, warmup_steps: int = 100,
                    total_steps: int = 10_000, weight_decay: float = 0.1,
                    clip_norm: float = 1.0, accum: int = 1, aux_weight: float = 0.01,
                    remat: bool = True, impl: str = "plain") -> Callable:
    """The train step (optionally with gradient accumulation over ``accum``
    microbatches, whose gradients and losses are averaged).  Metrics:
    ``loss``, ``xent``, ``moe_aux``, ``grad_norm`` (before clipping) and
    ``lr``, float32 0-d tensors on the parameters' device (reading one
    waits for the step).

    On a mesh the parameters and moments are DTensors, the batch too
    (``launch/train.py``), and the step runs under the launcher's
    ``ctx.use_rules``; plain tensors the model makes (positions, masks) take
    part as replicated values (``implicit_replication``).  Each gradient is
    brought to its parameter's placements before clipping, whose norm is
    then the global one, and AdamW updates each rank's shards; the metrics
    come back whole on every rank."""
    _check_impl(impl)

    def grads_of(params, batch):
        return loss_and_grads(cfg, params, batch, aux_weight=aux_weight, remat=remat,
                              impl=impl)

    def step(params, opt_state, batch):
        leaves, treedef = tree_flatten(params)
        on_mesh = isinstance(leaves[0], DTensor)
        with implicit_replication() if on_mesh else contextlib.nullcontext():
            new_params, new_opt, metrics = _step(params, leaves, treedef, opt_state, batch)
        return new_params, new_opt, {k: _full(v) for k, v in metrics.items()}

    def _step(params, leaves, treedef, opt_state, batch):
        if accum == 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for mb in _microbatches(batch, accum):
                mb_loss, _, mb_grads = grads_of(params, mb)
                grads = [a + g for a, g in zip(grads, mb_grads)]
                loss = loss + mb_loss
            grads = [g / accum for g in grads]
            loss = loss / accum
            metrics = {"xent": loss, "moe_aux": torch.zeros_like(loss)}
        grads, gnorm = clip_by_global_norm(tree_unflatten(treedef, grads), clip_norm)
        lr = cosine_schedule(opt_state.step, peak_lr=peak_lr, warmup_steps=warmup_steps,
                             total_steps=total_steps)
        new_params, new_opt = adamw_update(grads, opt_state, params, lr=lr,
                                           weight_decay=weight_decay)
        return new_params, new_opt, dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)

    return step
