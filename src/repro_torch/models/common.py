"""Shared model building blocks (the port's ``src/repro/models/common.py``).

Parameters are declared as a nested dict of :class:`ParamDecl` (shape,
logical dim names, init scale).  The same template materializes three ways:

* ``init_params``   - real tensors, drawn from an explicit ``torch.Generator``;
* ``param_structs`` - meta-device tensors (shapes and dtypes, no storage);
* ``param_specs``   - a spec per leaf through the logical -> mesh-axis rules
  (``distributed/sharding.py``): a tuple with one entry per dim, ``None``,
  an axis name or a tuple of axis names, as the JAX package's
  ``PartitionSpec``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

PyTree = Any


Spec = Tuple[Any, ...]  # per dim: None, an axis name, or a tuple of axis names


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]  # logical name per dim (None = replicated)
    scale: float = 1.0  # stddev multiplier on fan-in init; 0 -> zeros; -1 -> ones
    # alternative whole-tuple layout used when any *primary* named dim fails
    # mesh divisibility (the EP layout of MoE weights -> the expert-TP layout
    # when the expert count does not divide the model axis)
    alt_logical: Optional[Tuple[Optional[str], ...]] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)
        if self.alt_logical is not None:
            assert len(self.shape) == len(self.alt_logical)


def is_decl(x) -> bool:
    return isinstance(x, ParamDecl)


def tree_map_decl(f: Callable[[ParamDecl], Any], tree: PyTree) -> PyTree:
    """Map ``f`` over the ``ParamDecl`` leaves of a template."""
    return tree_map(f, tree)


def tree_map(f: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Map ``f`` over the leaves of nested dicts and lists (dict keys
    sorted, as jax orders them)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(f, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return f(tree, *rest)


_LEAF = object()  # a leaf's place in a treedef


def tree_flatten(tree: PyTree) -> Tuple[list, PyTree]:
    """(leaves, treedef) in the JAX package's leaf order (``jax.tree.flatten``):
    dict keys sorted, lists, tuples and NamedTuples in order, ``None`` an
    empty subtree.  The treedef is the tree with every leaf replaced by a
    marker; ``tree_unflatten`` fills it."""
    leaves: list = []

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(walk(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(x) for x in t)
        if t is None:
            return None
        leaves.append(t)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef: PyTree, leaves) -> PyTree:
    """The tree of ``treedef`` (from ``tree_flatten``) holding ``leaves`` in
    order; their count must match."""
    it = iter(leaves)
    end = object()

    def build(t):
        if t is _LEAF:
            leaf = next(it, end)
            if leaf is end:
                raise ValueError("fewer leaves than the treedef holds")
            return leaf
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return t

    out = build(treedef)
    if next(it, end) is not end:
        raise ValueError("more leaves than the treedef holds")
    return out


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def init_params(template: PyTree, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None,
                cast: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None) -> PyTree:
    """Real tensors for a template: N(0, scale / sqrt(fan_in)) with fan_in
    the second-to-last dim (the last for vectors), zeros for scale 0 and
    ones for scale -1.  Leaves are drawn in the template's sorted order
    from ``generator``, which must live on ``device``.  ``cast(key, leaf)``,
    when given, maps each leaf (by its dict key) before the next is drawn,
    so a cast copy never waits beside the whole float32 tree."""
    dev = generator.device if device is None else torch.device(device)

    def one(d: ParamDecl) -> torch.Tensor:
        if d.scale == 0.0:
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.scale == -1.0:
            return torch.ones(d.shape, dtype=dtype, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / (fan_in ** 0.5)
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32, device=dev)
        return x.mul_(std).to(dtype)

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(tree[k], k) for k in sorted(tree)}
        if isinstance(tree, (list, tuple)):
            return [walk(t, key) for t in tree]
        leaf = one(tree)
        return leaf if cast is None else cast(key, leaf)

    return walk(template)


def param_structs(template: PyTree, dtype: torch.dtype = torch.float32) -> PyTree:
    """Meta-device tensors of the template's shapes: no storage."""
    return tree_map_decl(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"),
                         template)


def flat_axes(ax) -> Tuple[str, ...]:
    """The mesh axes of a spec entry (an axis name or a tuple of them)."""
    return tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)


def axis_size(mesh_sizes: Dict[str, int], ax) -> int:
    """The product of the sizes of ``ax``'s mesh axes (1 for ``None``)."""
    n = 1
    for a in (() if ax is None else flat_axes(ax)):
        n *= mesh_sizes.get(a, 1)
    return n


def dim_spec(shape, logical, rules: Dict[str, Any],
             mesh_sizes: Dict[str, int]) -> Tuple[Spec, bool]:
    """(spec, every named dim kept) of one layout: each dim's axes through
    ``rules``, or None where the name maps to nothing, its size does not
    divide the axes' product, or an earlier dim already took an axis."""
    spec = []
    used: set = set()
    all_ok = True
    for size, name in zip(shape, logical):
        ax = rules.get(name) if name else None
        if ax is None:
            spec.append(None)
            continue
        n = axis_size(mesh_sizes, ax)
        if n <= 1 or size % n != 0 or any(a in used for a in flat_axes(ax)):
            spec.append(None)
            all_ok = False
            continue
        used.update(flat_axes(ax))
        spec.append(tuple(ax) if isinstance(ax, list) else ax)
    return tuple(spec), all_ok


def param_specs(template: PyTree, rules: Dict[str, Any]) -> PyTree:
    """A spec per leaf from logical dim names through ``rules`` (logical
    name -> None, an axis, or a tuple of axes; ``rules["_mesh_sizes"]``
    the axis sizes), by ``dim_spec``; when a primary named dim falls back
    to replicated, the whole ``alt_logical`` layout takes over, as in the
    JAX package."""
    mesh_sizes = rules.get("_mesh_sizes", {})

    def one(d: ParamDecl) -> Spec:
        spec, ok = dim_spec(d.shape, d.logical, rules, mesh_sizes)
        if not ok and d.alt_logical is not None:
            spec, _ = dim_spec(d.shape, d.alt_logical, rules, mesh_sizes)
        return spec

    return tree_map_decl(one, template)


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in float32, returned in x's dtype."""
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * w.float()).to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """Layer norm in float32, returned in x's dtype."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    ang = positions[..., :, None, None].float() * freqs  # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """(t, h, w) half-dim sections; qwen2-vl uses (16, 24, 24) for D=128."""
    half = head_dim // 2
    t = half // 4
    rem = half - t
    return (t, rem // 2, rem - rem // 2)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): positions (3, ..., S) for the (t, h, w)
    axes, each rotating its own section of the head dim."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_freqs(d, theta, x.device)  # (half,)
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                        for i, s in enumerate(mrope_sections(d))])  # (half,)
    # per frequency, its (t|h|w) position stream: (..., S, half)
    pos = torch.movedim(positions.float()[sec_id], 0, -1)
    ang = pos[..., None, :] * freqs  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoid_rows(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings of positions ``pos``
    (any shape) -> (*pos.shape, d_model), float32."""
    half = d_model // 2
    log_base = torch.log(torch.tensor(10_000.0, device=pos.device))  # float32, as jnp
    freq = torch.exp(-log_base * torch.arange(half, dtype=torch.float32, device=pos.device)
                     / (half - 1))
    ang = pos.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoid_positions(seq: int, d_model: int, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (seq, d_model), float32."""
    return sinusoid_rows(torch.arange(seq, dtype=torch.float32, device=device), d_model)


# ------------------------------------------------------------------ MLP acts
def glu_act(name: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(gate) * up
    if name == "gelu":
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(name)
