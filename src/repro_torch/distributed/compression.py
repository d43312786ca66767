"""Cross-pod gradient compression: int8 quantization with error feedback
(the port's ``src/repro/distributed/compression.py``).

The ``pod`` axis is the slow link between pods; the only traffic across it
is the gradient all-reduce.  Compressing that all-reduce 4x (float32 ->
int8 with a scale per leaf) cuts its time in proportion; the quantization
residual is carried in an error-feedback buffer, so the optimizer sees an
unbiased long-run gradient.

    comp, ef = compress(grads, ef)                  # int8 payload + residual
    grads = psum_compressed(comp, group, n)         # all-reduce over the pods

Trees are nested dicts and lists of plain tensors (``models.common``'s
``tree_map``); the all-reduce runs over a ``torch.distributed`` process
group (the ``pod`` axis's group of a mesh).  A library, as in the JAX
package: no launcher flag drives it.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_flatten, tree_map, tree_unflatten

PyTree = Any


class Compressed(NamedTuple):
    q: PyTree  # int8 tree
    scale: PyTree  # float32 0-d tensor per leaf


def ef_init(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _one(g: torch.Tensor, e: torch.Tensor):
    x = g.float() + e
    scale = torch.clamp_min(torch.amax(torch.abs(x)), 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale, x - q.float() * scale


def compress(grads: PyTree, ef: PyTree) -> Tuple[Compressed, PyTree]:
    """Quantize (grads + ef) to int8 (round half to even, as ``jnp.round``);
    return the payload and the new error residual."""
    flat, treedef = tree_flatten(grads)
    out = [_one(g, e) for g, e in zip(flat, tree_flatten(ef)[0])]
    return (Compressed(q=tree_unflatten(treedef, [o[0] for o in out]),
                       scale=tree_unflatten(treedef, [o[1] for o in out])),
            tree_unflatten(treedef, [o[2] for o in out]))


def decompress(c: Compressed) -> PyTree:
    return tree_map(lambda q, s: q.float() * s, c.q, c.scale)


def psum_compressed(c: Compressed, group, n: int) -> PyTree:
    """The mean over the ``n`` ranks of ``group``: the int8 payload summed
    in int32 (no int8 overflow across ``n`` pods), the scales' max."""
    def reduce(x: torch.Tensor, op) -> torch.Tensor:
        x = x.clone()
        dist.all_reduce(x, op=op, group=group)
        return x

    summed = tree_map(lambda q: reduce(q.to(torch.int32), dist.ReduceOp.SUM), c.q)
    scale = tree_map(lambda s: reduce(s, dist.ReduceOp.MAX), c.scale)
    return tree_map(lambda si, sc: si.float() * sc / n, summed, scale)


def compressed_allreduce(grads: PyTree, ef: PyTree, group, n: int
                         ) -> Tuple[PyTree, PyTree]:
    """One call: (the mean gradients across the group, the new residual)."""
    c, new_ef = compress(grads, ef)
    return psum_compressed(c, group, n), new_ef
