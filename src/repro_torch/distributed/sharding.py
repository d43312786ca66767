"""Logical-axis -> mesh-axis sharding rules (the port's
``src/repro/distributed/sharding.py``).

One table maps every logical parameter dimension (declared next to the
parameter in ``models/transformer.py``) to mesh axes:

* ``model`` - Megatron-style tensor parallelism: attention heads, FFN
  hidden, the expert dim (expert parallelism when the expert count divides
  the axis, the expert-TP layout otherwise: ``common.param_specs``), the
  SSD inner dim, the vocab of the embeddings;
* ``data`` - FSDP / ZeRO-3: the ``embed`` (d_model) dim of every weight is
  split over ``data``;
* ``pod`` - pure data parallelism between pods: parameters replicated pod
  to pod, only the gradient all-reduce crosses (``compression.py``).

Activations: the batch splits over ``("pod", "data")``; decode KV caches
split batch over the same and their sequence over ``model``.

A spec is a tuple with one entry per dim: ``None``, an axis name or a tuple
of axis names (the JAX package's ``PartitionSpec``).  On the port's
``DeviceMesh`` a spec becomes DTensor placements (``ctx.placements``):
``params_sharding`` gives them per parameter leaf, and the AdamW moments
take their parameter's.  The layout functions also take a
``core.distributed.MeshLayout`` (names and sizes, no ranks).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import Placement
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed.ctx import Spec, placements
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models.common import param_specs

PyTree = Any

# logical dim name -> mesh axis (tuples = multi-axis sharding)
LOGICAL_RULES: Dict[str, Any] = {
    "vocab": "model",
    "embed": "data",  # FSDP: every weight's d_model dim split over data
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "moe_ff": "model",  # expert-TP fallback layout (E % model != 0)
    "moe_ff_ep": "data",  # EP layout: experts over model, hidden over data
    "experts": "model",  # EP when divisible; else the alt_logical layout
    "ssm_inner": "model",
    "layers": None,  # the stacked-layers dim stays whole
    # activations (ctx.constrain): the residual stream's seq dim over model
    "seq": "model",
}


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes carrying the batch dim: ("pod", "data") multi-pod, ("data",)
    single."""
    names = mesh_axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def make_rules(mesh, overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    rules = dict(LOGICAL_RULES)
    rules["_mesh_sizes"] = mesh_axis_sizes(mesh)
    rules["batch"] = batch_axes(mesh)  # activation batch dim (ctx.constrain)
    if overrides:
        rules.update(overrides)
    return rules


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def spec_tree(template: PyTree, mesh, overrides: Optional[Dict[str, Any]] = None
              ) -> PyTree:
    """The spec of every leaf of a ``ParamDecl`` template on ``mesh``."""
    return param_specs(template, make_rules(mesh, overrides))


def named_sharding_tree(mesh, specs: PyTree) -> PyTree:
    """DTensor placements on ``mesh`` for every spec of a spec tree."""
    if _is_spec(specs):
        return placements(mesh, specs)
    if isinstance(specs, dict):
        return {k: named_sharding_tree(mesh, v) for k, v in specs.items()}
    return [named_sharding_tree(mesh, v) for v in specs]


def params_sharding(cfg, mesh, template: PyTree,
                    overrides: Optional[Dict[str, Any]] = None) -> PyTree:
    """DTensor placements on ``mesh`` for every leaf of the parameter
    template (and, leaf for leaf, the AdamW moments)."""
    del cfg  # the template carries the config's shapes
    return named_sharding_tree(mesh, spec_tree(template, mesh, overrides))


def placement_leaves(tree: PyTree) -> List[Any]:
    """The leaves of a placements tree in the JAX package's leaf order
    (``models.common.tree_flatten``'s): each a tuple of ``Placement``s, or
    ``None`` for a leaf that stays a plain tensor (the AdamW step count)."""
    out: List[Any] = []

    def walk(t):
        if t is None or (isinstance(t, tuple) and t and all(isinstance(p, Placement)
                                                            for p in t)):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            for x in t:
                walk(x)

    walk(tree)
    return out


# ----------------------------------------------------------------- activations
def _bspec(mesh, global_batch: int):
    sizes = mesh_axis_sizes(mesh)
    ba = batch_axes(mesh)
    n = 1
    for a in ba:
        n *= sizes[a]
    return ba if ba and global_batch % n == 0 else None  # () is replicated too


def input_sharding(cfg, shape, mesh) -> Dict[str, Spec]:
    """The spec of every input of a step of ``shape`` (a ``ShapeSpec``:
    ``kind``, ``global_batch``, ``seq_len``)."""
    bspec = _bspec(mesh, shape.global_batch)
    sh: Dict[str, Spec] = {}
    if shape.kind == "train":
        sh["inputs"] = (bspec, None)
        sh["targets"] = (bspec, None)
    elif shape.kind == "prefill":
        sh["tokens"] = (bspec, None)
    else:  # decode
        sh["token"] = (bspec, None)
        sh["pos"] = (bspec,)
    if cfg.vision_tokens and shape.kind != "decode":
        sh["vision_embeds"] = (bspec, None, None)
        sh["mrope_pos"] = (None, bspec, None)
    if cfg.is_encdec and shape.kind != "decode":
        sh["frames"] = (bspec, None, None)
    return sh


def cache_spec(cfg, shape, mesh, *, seq_axis: Any = "model") -> PyTree:
    """The spec tree of ``transformer.cache_template``.

    Attention KV (layers, B, C, KV, Dh): batch over ("pod", "data") when it
    divides, the cache's sequence over ``seq_axis``; Mamba state (layers, B,
    H, N, P): batch, and the inner heads over ``model``; each dim falls back
    to replicated when it does not divide."""
    from repro_torch.models.transformer import cache_template

    bspec = _bspec(mesh, shape.global_batch)
    m = mesh_axis_sizes(mesh).get("model", 1)

    def spec_for(key: str, shp) -> Spec:
        if key in ("k", "v", "xk", "xv"):  # (L, B, C, KV, Dh)
            seq = seq_axis if seq_axis and shp[2] % max(m, 1) == 0 else None
            return (None, bspec, seq, None, None)
        if key == "ssm":  # (L, B, H, N, P)
            return (None, bspec, "model" if shp[2] % m == 0 else None, None, None)
        if key == "conv":  # (L, B, K-1, conv_ch)
            return (None, bspec, None, "model" if shp[3] % m == 0 else None)
        raise KeyError(key)

    tmpl = cache_template(cfg, shape.global_batch, shape.seq_len)
    return [{k: spec_for(k, shp) for k, (shp, _) in slot.items()} for slot in tmpl]


# ----------------------------------------------------------------- collectives
@dataclasses.dataclass
class CommStats:
    """Collectives run under ``count_collectives``: calls, and the bytes
    they brought in (each call's output), by op name, and each call's
    (op, bytes) in order."""

    calls: int = 0
    bytes: int = 0
    by_op: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    sizes: List[Tuple[str, int]] = dataclasses.field(default_factory=list)

    def reset(self) -> None:
        self.calls = self.bytes = 0
        self.by_op = {}
        self.sizes = []


COMM = CommStats()
# DTensor's functional collectives, and the plain ones that ``dist.all_reduce``
# and the other ``torch.distributed`` calls dispatch to
COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _outputs(ns: str, args, out) -> list:
    """The tensors a collective writes: a functional one's result, a plain
    ``c10d`` one's first argument (its output buffers, in place)."""
    outs = args[0] if ns == "c10d" else out
    flat, stack = [], [outs]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            flat.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return flat


class count_collectives(TorchDispatchMode):
    """Counts into ``COMM`` every collective run while it is entered, on the
    calling thread and in the backward passes it starts: DTensor's
    functional collectives (the ops it lowers its redistributions to) and
    the plain ``c10d`` ones, each call once."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor lowers it first, into local ops
        out = func(*args, **(kwargs or {}))
        ns = getattr(func, "namespace", "")
        name = func.__name__.split(".")[0]
        # not wait_tensor, nor the functional helpers (``_wrap_tensor_autograd``
        # wraps each collective's output for autograd: counting it counts
        # twice); ``c10d._allgather_base_`` is a collective
        if (ns in COLLECTIVE_NAMESPACES and name != "wait_tensor"
                and (ns == "c10d" or not name.startswith("_"))):
            n = sum(o.numel() * o.element_size() for o in _outputs(ns, args, out))
            COMM.calls += 1
            COMM.bytes += n
            COMM.sizes.append((name, n))
            c = COMM.by_op.setdefault(name, [0, 0])
            c[0] += 1
            c[1] += n
        return out
