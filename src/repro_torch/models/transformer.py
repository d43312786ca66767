"""LM assembly for every model family (the port's
``src/repro/models/transformer.py``): dense, MoE, SSM, hybrid,
encoder-decoder and VLM.

* ``ModelConfig.layer_plan()`` gives the repeating *period* of (mixer, ffn)
  sub-layer kinds; the parameters of each in-period slot are stacked over
  ``n_blocks``, as in the JAX package, and a Python loop walks the stack.
* Entry points: ``forward`` (full sequence), ``prefill`` (full sequence
  returning a decode cache), ``decode_step`` (one token per sequence with
  the carried cache, updated in place: the JAX package donates it).
  Training calls ``forward(..., remat=True, return_hidden=True)`` with
  ``impl="plain"`` and ``head_weight`` (``train/step.py``).
* ``impl="kernel"`` (the default) runs every full-sequence attention call
  (causal self-attention, and whisper's non-causal encoder self-attention
  and prefill cross-attention) and the SSD scan through the kernel
  wrappers (``kernels/flash_attention``, ``kernels/ssd_scan``): the CUDA
  kernels on the card, their plain versions on the CPU.  ``impl="plain"``
  calls the plain chunked versions directly on any device (the JAX
  package's ``attn_impl="jnp"``, which its encoder and cross-attention
  always take).  Decode attention is plain PyTorch on both.
* MoE layers (``models/moe.py``), whisper's encoder and cross-attention
  (cross-KV kept in the cache as ``xk`` / ``xv``), mrope position streams
  and a vision-embedding prefix (qwen2-vl) follow the JAX package.

Activations are bf16 (the embedding is cast to bf16), every weight is cast
to the activation dtype where it is used, norms, the router and the SSD
run in float32.  ``compute_params`` makes those casts once, for serving.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.ctx import (
    all_reduce_over,
    batch_rows,
    constrain,
    local_rows,
    logical_axis_size,
    project,
)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (
    ParamDecl,
    apply_mrope,
    apply_rope,
    glu_act,
    init_params,
    param_structs,
    rms_norm,
    sinusoid_positions,
    sinusoid_rows,
    tree_map,
)

PyTree = Any
ACT_DTYPE = torch.bfloat16


# ======================================================================
# parameter templates
# ======================================================================


def _attn_decl(cfg: ModelConfig) -> Dict[str, ParamDecl]:
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    decl = {
        "norm_w": ParamDecl((d,), ("embed",), -1.0),
        "wq": ParamDecl((d, H * Dh), ("embed", "heads")),
        "wk": ParamDecl((d, KV * Dh), ("embed", "kv_heads")),
        "wv": ParamDecl((d, KV * Dh), ("embed", "kv_heads")),
        "wo": ParamDecl((H * Dh, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        decl["bq"] = ParamDecl((H * Dh,), ("heads",), 0.0)
        decl["bk"] = ParamDecl((KV * Dh,), ("kv_heads",), 0.0)
        decl["bv"] = ParamDecl((KV * Dh,), ("kv_heads",), 0.0)
    return decl


def _xattn_decl(cfg: ModelConfig) -> Dict[str, ParamDecl]:
    """Cross-attention (whisper decoder); KV projected from encoder states."""
    d, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    return {
        "norm_w": ParamDecl((d,), ("embed",), -1.0),
        "wq": ParamDecl((d, H * Dh), ("embed", "heads")),
        "wk": ParamDecl((d, KV * Dh), ("embed", "kv_heads")),
        "wv": ParamDecl((d, KV * Dh), ("embed", "kv_heads")),
        "wo": ParamDecl((H * Dh, d), ("heads", "embed")),
    }


def _mlp_decl(cfg: ModelConfig) -> Dict[str, ParamDecl]:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "norm_w": ParamDecl((d,), ("embed",), -1.0),
        "w_gate": ParamDecl((d, f), ("embed", "ff")),
        "w_up": ParamDecl((d, f), ("embed", "ff")),
        "w_down": ParamDecl((f, d), ("ff", "embed")),
    }


def _moe_decl(cfg: ModelConfig) -> Dict[str, ParamDecl]:
    """Expert weights: the EP layout first (experts over ``model``, expert
    hidden over ``data``, d_model unsharded), the expert-TP layout (hidden
    over ``model``, d_model over ``data``) when the expert count does not
    divide the model axis (mixtral's 8 experts on 16)."""
    d, f, E = cfg.d_model, cfg.moe_d_ff_, cfg.n_experts
    ep_in = (("experts", None, "moe_ff_ep"), ("experts", "embed", "moe_ff"))
    ep_out = (("experts", "moe_ff_ep", None), ("experts", "moe_ff", "embed"))
    return {
        "norm_w": ParamDecl((d,), ("embed",), -1.0),
        "router": ParamDecl((d, E), ("embed", None)),
        "w_gate": ParamDecl((E, d, f), ep_in[0], alt_logical=ep_in[1]),
        "w_up": ParamDecl((E, d, f), ep_in[0], alt_logical=ep_in[1]),
        "w_down": ParamDecl((E, f, d), ep_out[0], alt_logical=ep_out[1]),
    }


def _mamba_decl(cfg: ModelConfig) -> Dict[str, ParamDecl]:
    d = cfg.d_model
    d_inner, G, N, H, Pd, conv_ch, d_in_proj = mamba_lib._dims(cfg)
    return {
        "norm_w_in": ParamDecl((d,), ("embed",), -1.0),
        "w_in": ParamDecl((d, d_in_proj), ("embed", "ssm_inner")),
        "conv_w": ParamDecl((cfg.ssm_conv, conv_ch), (None, "ssm_inner")),
        "conv_b": ParamDecl((conv_ch,), ("ssm_inner",), 0.0),
        "A_log": ParamDecl((H,), (None,), -1.0),  # init A = -1
        "D": ParamDecl((H,), (None,), -1.0),
        "dt_bias": ParamDecl((H,), (None,), 0.0),
        "norm_w": ParamDecl((d_inner,), ("ssm_inner",), -1.0),
        "w_out": ParamDecl((d_inner, d), ("ssm_inner", "embed")),
    }


_SLOT_DECL = {"attn": _attn_decl, "mamba": _mamba_decl, "mlp": _mlp_decl, "moe": _moe_decl}


def _stack(tree: PyTree, n: int) -> PyTree:
    """Add a leading stacked-layers dim (logical ``"layers"``) to every
    ParamDecl."""
    return tree_map(lambda dl: ParamDecl(
        (n,) + dl.shape, ("layers",) + dl.logical, dl.scale,
        alt_logical=("layers",) + dl.alt_logical if dl.alt_logical else None), tree)


def param_template(cfg: ModelConfig) -> PyTree:
    d, V = cfg.d_model, cfg.vocab_size
    blocks = []
    for mixer, ffn in cfg.layer_plan():
        slot: Dict[str, Any] = {"mixer": _SLOT_DECL[mixer](cfg)}
        if cfg.is_encdec:
            slot["xattn"] = _xattn_decl(cfg)
        if ffn != "none":
            slot["ffn"] = _SLOT_DECL[ffn](cfg)
        blocks.append(slot)
    t: Dict[str, Any] = {
        "embed": ParamDecl((V, d), ("vocab", "embed")),
        "blocks": _stack(blocks, cfg.n_blocks),
        "final_norm": ParamDecl((d,), ("embed",), -1.0),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamDecl((d, V), ("embed", "vocab"))
    if cfg.is_encdec:
        # stub frontend: precomputed frame embeddings -> linear projection
        t["encoder"] = {
            "frames_proj": ParamDecl((d, d), ("embed", None)),
            "blocks": _stack([{"mixer": _attn_decl(cfg), "ffn": _mlp_decl(cfg)}],
                             cfg.encoder_layers),
            "final_norm": ParamDecl((d,), ("embed",), -1.0),
        }
    return t


def init(cfg: ModelConfig, generator: torch.Generator, dtype=torch.float32,
         device=None) -> PyTree:
    """Random parameters from ``generator`` (on ``device``, default the
    generator's), float32 masters as in the JAX package."""
    return init_params(param_template(cfg), generator, dtype, device)


def template_structs(cfg: ModelConfig, dtype=torch.float32) -> PyTree:
    """The parameters' shapes and dtype as meta-device tensors (no storage)."""
    return param_structs(param_template(cfg), dtype)


# weights the model casts to the activation dtype wherever it uses them (the
# MoE router is not one: it runs in float32)
_CAST_AT_USE = frozenset({"embed", "lm_head", "wq", "wk", "wv", "wo", "bq", "bk",
                          "bv", "w_gate", "w_up", "w_down", "w_in", "conv_w",
                          "conv_b", "w_out", "D", "frames_proj"})


def _cast_at_use(dtype):
    return lambda name, leaf: leaf.to(dtype) if name in _CAST_AT_USE else leaf


def compute_params(params: PyTree, dtype=ACT_DTYPE) -> PyTree:
    """A copy for serving with every weight that is cast to the activation
    dtype at each use cast once, here; norm weights, the router, ``A_log``
    and ``dt_bias`` keep their float32 masters.  The model computes the
    same numbers from either tree."""
    cast = _cast_at_use(dtype)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, name) for v in tree]
        return cast(name, tree)
    return walk(params)


def init_compute_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                        dtype=ACT_DTYPE) -> PyTree:
    """``compute_params(init(cfg, generator, device=device))`` bit for bit,
    each leaf cast as soon as it is drawn: the peak is the cast tree plus
    one float32 leaf, not the whole float32 tree beside its copy."""
    return init_params(param_template(cfg), generator, torch.float32, device,
                       cast=_cast_at_use(dtype))


def layer(tree: PyTree, i: int) -> PyTree:
    """Layer ``i`` of a tree stacked over blocks (views, no copies)."""
    return tree_map(lambda t: t[i], tree)


def _unbind(t: torch.Tensor) -> List[torch.Tensor]:
    """The layers of one stacked leaf (views).  A DTensor is unbound on its
    local tensor (the stacked dim is never split) and each layer wrapped
    with the placements of the dims that remain."""
    if not isinstance(t, DTensor):
        return list(torch.unbind(t, 0))
    places = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in t.placements]
    return [DTensor.from_local(x, t.device_mesh, places, run_check=False,
                               shape=t.shape[1:], stride=t.stride()[1:])
            for x in torch.unbind(t.to_local(), 0)]


def layers(tree: PyTree, n: int) -> List[PyTree]:
    """The ``n`` layers of a tree stacked over blocks, each leaf unbound
    once (views, no copies; in-place writes reach the stack).  Its backward
    stacks the layers' gradients once, where ``layer(tree, i)`` for every
    ``i`` makes each layer's gradient a zero tensor of the whole stack, a
    step's bytes quadratic in depth."""
    def walk(t) -> List[PyTree]:  # the n per-layer trees of ``t``
        if isinstance(t, dict):
            subs = {k: walk(v) for k, v in t.items()}
            return [{k: v[i] for k, v in subs.items()} for i in range(n)]
        if isinstance(t, (list, tuple)):
            subs = [walk(v) for v in t]
            return [[v[i] for v in subs] for i in range(n)]
        return _unbind(t)

    return walk(tree)


# ======================================================================
# sub-layers
# ======================================================================


def _wc(p, name, dtype, logical):
    """Weight compute-copy: cast to the compute dtype and, on a mesh,
    redistribute the copy to the gathered layout (the FSDP dim whole, the
    TP dims kept), so the gather moves the bf16 copy, not the float32
    master.  The weight itself outside a context."""
    return constrain(p[name].to(dtype), logical)


def _split_heads(x, n, d):
    return x.reshape(x.shape[:-1] + (n, d))


def _heads(name: str, n: int):
    """The logical name of a projection's head dim (``"heads"`` or
    ``"kv_heads"``) when its ``n`` heads divide the mesh axes the name maps
    to, else None: the weight's bf16 copy is then laid out whole along
    those axes, so the projection's output is too and a rank never holds
    part of a head (DTensor cannot split (..., n * Dh) into heads unevenly).
    The name itself off a mesh."""
    return name if n % logical_axis_size(name) == 0 else None


def _qkv(cfg, p, h):
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = project(h, _wc(p, "wq", h.dtype, (None, _heads("heads", H))))
    k = project(h, _wc(p, "wk", h.dtype, (None, _heads("kv_heads", KV))))
    v = project(h, _wc(p, "wv", h.dtype, (None, _heads("kv_heads", KV))))
    if cfg.qkv_bias:  # each bias laid out as its projection's output
        q = q + _wc(p, "bq", q.dtype, (_heads("heads", H),))
        k = k + _wc(p, "bk", k.dtype, (_heads("kv_heads", KV),))
        v = v + _wc(p, "bv", v.dtype, (_heads("kv_heads", KV),))
    return _split_heads(q, H, Dh), _split_heads(k, KV, Dh), _split_heads(v, KV, Dh)


def _rope(cfg, q, k, positions, mrope_pos):
    if cfg.rope_type == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope_type == "mrope":
        q = apply_mrope(q, mrope_pos, cfg.rope_theta)
        k = apply_mrope(k, mrope_pos, cfg.rope_theta)
    return q, k


def _attention(q, k, v, *, causal, window, impl):
    """Full-sequence attention: the kernel wrapper, or the plain chunked
    version with ``impl="plain"``.  The plain version takes Skv <= 1024 or
    a multiple of 1024, as the JAX package's jnp path; the kernel takes any
    Skv, also for whisper's non-causal encoder and cross-attention over any
    number of frames (it masks a ragged last KV tile)."""
    if isinstance(q, DTensor):
        return _attention_mesh(q, k, v, causal=causal, window=window, impl=impl)
    if impl == "plain":
        return attn_lib.flash_attention(q, k, v, causal=causal, window=window,
                                        chunk=min(1024, k.shape[1]))
    return fa_ops.flash_attention(q, k, v, causal=causal, window=window, ragged_kv=True)


def _attention_mesh(q, k, v, *, causal, window, impl):
    """``_attention`` of DTensors (B, S, heads, D) on each rank's own
    sequences and heads: the batch split where q's is, the heads where q's
    are and the KV heads divide too (a rank's query heads are then the
    groups of its KV heads), every sequence whole.  No sharding rule runs
    inside, and no collective."""
    mesh = q.device_mesh
    KV = k.shape[2]
    lay = [p if p == Shard(0) or (p == Shard(2) and KV % mesh.size(i) == 0) else Replicate()
           for i, p in enumerate(q.placements)]
    q, k, v = (t.redistribute(mesh, lay).to_local() for t in (q, k, v))
    o = _attention(q, k, v, causal=causal, window=window, impl=impl)
    return DTensor.from_local(o, mesh, lay, run_check=False)


def attn_full(cfg, p, x, *, positions, mrope_pos=None, causal=True, impl="kernel"):
    """Full-sequence self-attention sublayer.  Returns (out, (k, v))."""
    B, S, d = x.shape
    h = rms_norm(x, p["norm_w"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h)
    q, k = _rope(cfg, q, k, positions, mrope_pos)
    o = _attention(q, k, v, causal=causal, window=cfg.sliding_window, impl=impl)
    out = project(o.reshape(B, S, -1), _wc(p, "wo", o.dtype, ("heads", None)))
    return x + out, (k, v)


def xattn_full(cfg, p, x, enc_kv, *, impl="kernel"):
    """Cross-attention (non-causal) with precomputed encoder (k, v)."""
    B, S, d = x.shape
    k, v = enc_kv
    h = rms_norm(x, p["norm_w"], cfg.norm_eps)
    q = _split_heads(project(h, _wc(p, "wq", h.dtype, (None, _heads("heads", cfg.n_heads)))),
                     cfg.n_heads, cfg.head_dim_)
    o = _attention(q, k, v, causal=False, window=0, impl=impl)
    return x + project(o.reshape(B, S, -1), _wc(p, "wo", o.dtype, ("heads", None)))


def xattn_decode(cfg, p, x, enc_kv):
    B, S1, d = x.shape
    k, v = enc_kv
    h = rms_norm(x, p["norm_w"], cfg.norm_eps)
    q = _split_heads(project(h, _wc(p, "wq", h.dtype, (None, _heads("heads", cfg.n_heads)))),
                     cfg.n_heads, cfg.head_dim_)
    if isinstance(q, DTensor):
        o = _decode_attention_mesh(q, k, v)
    else:
        o = attn_lib.decode_attention(q, k, v)
    return x + project(o.reshape(B, S1, -1), _wc(p, "wo", o.dtype, ("heads", None)))


def _build_xkv(cfg, p, enc_out):
    """Project encoder output to (k, v) for one decoder layer."""
    KV, Dh = cfg.n_kv_heads, cfg.head_dim_
    wk = _wc(p, "wk", enc_out.dtype, (None, _heads("kv_heads", KV)))
    wv = _wc(p, "wv", enc_out.dtype, (None, _heads("kv_heads", KV)))
    return (_split_heads(project(enc_out, wk), KV, Dh),
            _split_heads(project(enc_out, wv), KV, Dh))


def attn_decode(cfg, p, x, cache, *, pos, mrope_pos=None):
    """Single-token self-attention against a ring/linear KV cache.

    cache: {"k","v"}: (B, C, KV, Dh), written in place at row ``pos % C``
    of each sequence.  ``pos``: (B,) absolute position of each sequence's
    new token (every slot decodes at its own position); rows past each
    sequence's length are masked by its valid length.  With mrope and no
    ``mrope_pos`` (3, B, 1), the three streams all take ``pos``.  On a mesh
    (DTensors) the cache stays in its layout: ``_attn_decode_mesh``.
    """
    B, S1, d = x.shape
    C = cache["k"].shape[1]
    h = rms_norm(x, p["norm_w"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h)
    if cfg.rope_type == "mrope" and mrope_pos is None:
        mrope_pos = pos.expand(3, B)[..., None]
    q, k = _rope(cfg, q, k, pos[:, None], mrope_pos)
    if isinstance(q, DTensor):
        o = _attn_decode_mesh(q, k, v, cache, pos)
    else:
        rows = torch.arange(B, device=x.device)
        widx = torch.remainder(pos, C)
        cache["k"][rows, widx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, widx] = v[:, 0].to(cache["v"].dtype)
        valid = torch.clamp_max(pos + 1, C)
        o = attn_lib.decode_attention(q, cache["k"], cache["v"], valid_len=valid)
    out = project(o.reshape(B, S1, -1), _wc(p, "wo", o.dtype, ("heads", None)))
    return x + out, cache


def _same_batch_rows(rows, c: DTensor, dim: int) -> None:
    """A cache's batch dim ``dim`` must be split where the activations'
    batch is (``input_sharding`` and ``cache_spec`` both split it over
    ``batch_axes`` when it divides; a mesh dim of one rank splits
    nothing, and ``constrain`` leaves it whole)."""
    mesh = c.device_mesh
    mine = [pl == Shard(0) and mesh.size(i) > 1 for i, pl in enumerate(rows)]
    theirs = [pl == Shard(dim) and mesh.size(i) > 1 for i, pl in enumerate(c.placements)]
    if mine != theirs:
        raise ValueError(f"cache batch placements {c.placements} differ from the "
                         f"activations' {rows}")


def _attn_decode_mesh(q, k, v, cache, pos):
    """The decode step's cache write and attention on DTensors, the cache
    (B, C, KV, Dh) in its ``cache_spec`` layout (batch split as the
    activations', the sequence over ``model``) and never moved: each rank
    takes its sequences' query and new (k, v) with all heads (one token:
    small gathers), the rank that holds row ``pos % C`` writes it (a masked
    write of its local rows, the ring layout kept), and the attention is
    a softmax split over the ranks that hold rows
    (``attention.decode_attention_parts``: max, sum and ``p @ V`` over each
    rank's valid rows, combined in float32)."""
    mesh = q.device_mesh
    rows = batch_rows(q)
    ql = q.redistribute(mesh, rows).to_local()
    kl, vl = (t.redistribute(mesh, rows).to_local()[:, 0] for t in (k, v))
    posl = pos.redistribute(mesh, batch_rows(pos)).to_local()
    _same_batch_rows(rows, cache["k"], 0)
    kc, lo, split = local_rows(cache["k"], 1)
    vc = cache["v"].to_local()
    C, n = cache["k"].shape[1], kc.shape[1]
    li = torch.remainder(posl, C) - lo
    hit = ((li >= 0) & (li < n))[:, None, None]
    li = li.clamp(0, n - 1)
    b = torch.arange(kc.shape[0], device=kc.device)
    kc[b, li] = torch.where(hit, kl.to(kc.dtype), kc[b, li])
    vc[b, li] = torch.where(hit, vl.to(vc.dtype), vc[b, li])
    ok = (lo + torch.arange(n, device=kc.device))[None, :] < torch.clamp_max(posl + 1, C)[:, None]
    o = attn_lib.decode_attention_parts(ql, kc, vc, ok, all_reduce_over(mesh, split))
    return DTensor.from_local(o, mesh, rows, run_check=False)


def _decode_attention_mesh(q, k_cache: DTensor, v_cache: DTensor):
    """``decode_attention(q, k, v)`` of a query DTensor against a cache
    (B, S, KV, Dh) in its ``cache_spec`` layout, every row valid (whisper's
    cross-attention over the encoder frames): the split softmax of
    ``_attn_decode_mesh``, no write."""
    mesh = q.device_mesh
    rows = batch_rows(q)
    _same_batch_rows(rows, k_cache, 0)
    kc, _, split = local_rows(k_cache, 1)
    ok = torch.ones((kc.shape[0], kc.shape[1]), dtype=torch.bool, device=kc.device)
    o = attn_lib.decode_attention_parts(q.redistribute(mesh, rows).to_local(), kc,
                                        v_cache.to_local(), ok, all_reduce_over(mesh, split))
    return DTensor.from_local(o, mesh, rows, run_check=False)


def mlp_sublayer(cfg, p, x):
    h = rms_norm(x, p["norm_w"], cfg.norm_eps)
    g = project(h, _wc(p, "w_gate", h.dtype, (None, "ff")))
    u = project(h, _wc(p, "w_up", h.dtype, (None, "ff")))
    return x + project(glu_act(cfg.mlp_act, g, u), _wc(p, "w_down", h.dtype, ("ff", None)))


def moe_sublayer(cfg, p, x, *, with_aux=True):
    """Returns (x + MoE FFN output, the layer's aux load-balance loss, or
    None with ``with_aux=False``)."""
    h = rms_norm(x, p["norm_w"], cfg.norm_eps)
    y, aux = moe_lib.moe_ffn(h, p["router"], p["w_gate"], p["w_up"], p["w_down"],
                             topk=cfg.topk, capacity_factor=cfg.capacity_factor,
                             act=cfg.mlp_act, with_aux=with_aux)
    return x + y, aux


def _ffn(cfg, kind, p, x, aux):
    """The slot's FFN sublayer ("mlp", "moe" or "none"); adds a MoE layer's
    aux loss to ``aux``, or computes none when ``aux`` is None (decode)."""
    if kind == "mlp":
        return mlp_sublayer(cfg, p, x), aux
    if kind == "moe":
        x, a = moe_sublayer(cfg, p, x, with_aux=aux is not None)
        return x, None if aux is None else aux + a
    return x, aux


def mamba_full(cfg, p, x, *, return_cache=False, impl="kernel"):
    h = rms_norm(x, p["norm_w_in"], cfg.norm_eps)
    y, cache = mamba_lib.mamba_mixer(cfg, p, h, return_cache=return_cache, impl=impl)
    return x + y, cache


def mamba_decode_sub(cfg, p, x, cache):
    h = rms_norm(x, p["norm_w_in"], cfg.norm_eps)
    y, cache = mamba_lib.mamba_decode(cfg, p, h, cache)
    return x + y, cache


# ======================================================================
# caches
# ======================================================================


def cache_template(cfg: ModelConfig, batch: int, cache_len: int, dtype=ACT_DTYPE
                   ) -> List[Dict[str, Tuple[Tuple[int, ...], torch.dtype]]]:
    """(shape, dtype) of every decode-cache leaf, stacked over blocks.  An
    enc-dec attention slot also holds the cross-KV (``xk``, ``xv``) of
    ``cache_len`` encoder frames."""
    KV, Dh, nb = cfg.n_kv_heads, cfg.head_dim_, cfg.n_blocks
    C = cache_len if cfg.sliding_window == 0 else min(cache_len, cfg.sliding_window)
    slots = []
    for mixer, _ in cfg.layer_plan():
        if mixer == "attn":
            slot = {"k": ((nb, batch, C, KV, Dh), dtype),
                    "v": ((nb, batch, C, KV, Dh), dtype)}
            if cfg.is_encdec:
                slot["xk"] = ((nb, batch, cache_len, KV, Dh), dtype)
                slot["xv"] = ((nb, batch, cache_len, KV, Dh), dtype)
        else:
            d_inner, G, N, H, Pd, conv_ch, _ = mamba_lib._dims(cfg)
            slot = {"conv": ((nb, batch, cfg.ssm_conv - 1, conv_ch), dtype),
                    "ssm": ((nb, batch, H, N, Pd), torch.float32)}
        slots.append(slot)
    return slots


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=ACT_DTYPE,
               device=None) -> PyTree:
    return [{k: torch.zeros(shape, dtype=dt, device=device) for k, (shape, dt) in s.items()}
            for s in cache_template(cfg, batch, cache_len, dtype)]


def pad_cache(cfg: ModelConfig, cache: PyTree, capacity: int) -> PyTree:
    """Grow a prefill cache's KV capacity to ``capacity`` rows (serving).

    Linear-layout caches zero-pad at the tail (position p stays at index
    p; decode's valid length masks the unwritten rows).  Sliding-window
    ring caches at full window size are returned unchanged.  Cross-KV
    (``xk``, ``xv``) keeps the encoder's length.
    """
    target = min(capacity, cfg.sliding_window) if cfg.sliding_window else capacity

    def grow(x):  # (layers, B, C, KV, Dh)
        C = x.shape[2]
        if C >= target:
            return x
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, target - C))

    return [{k: grow(v) if k in ("k", "v") else v for k, v in s.items()} for s in cache]


# ======================================================================
# encoder (whisper)
# ======================================================================


def encode(cfg: ModelConfig, params: PyTree, frames: torch.Tensor, *,
           impl: str = "kernel") -> torch.Tensor:
    """frames: (B, S, d_model) stubbed frontend embeddings -> encoder states
    (non-causal self-attention + MLP per layer, then the final norm)."""
    enc = params["encoder"]
    B, S, d = frames.shape
    x = project(frames, enc["frames_proj"].to(frames.dtype))
    x = x + sinusoid_positions(S, d, frames.device).to(x.dtype)
    positions = torch.arange(S, device=frames.device)
    for sp in layers(enc["blocks"][0], cfg.encoder_layers):
        x = constrain(x, ("batch", "seq", None))
        x, _ = attn_full(cfg, sp["mixer"], x, positions=positions, causal=False, impl=impl)
        x = mlp_sublayer(cfg, sp["ffn"], x)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


# ======================================================================
# entry points
# ======================================================================


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]`` in the activation dtype.  On a mesh, vocab-parallel
    on each rank's own shard of the bf16 table (its vocab rows over
    ``model``, its d_model columns over ``data``): every rank takes all the
    batch's tokens (a small gather), looks up those in its rows (zeros
    for the rest) in its columns, and the rows are summed over the vocab
    split (one nonzero term: exact) and gathered over the columns' split,
    then laid out as the tokens are.  Each rank's table gradient is then
    whole on its shard: no collective reduces it (DTensor's own rule for
    the lookup's backward, an index_put, fails on a split table)."""
    if not isinstance(tokens, DTensor):
        return table.to(ACT_DTYPE)[tokens]
    mesh = tokens.device_mesh
    w = table.to(ACT_DTYPE)
    wl, tok = w.to_local(), tokens.full_tensor()
    n, lo = wl.shape[0], 0
    for i, p in enumerate(w.placements):
        if p == Shard(0):
            lo += mesh.get_coordinate()[i] * n  # one mesh dim splits the vocab
    idx = tok - lo
    hit = (idx >= 0) & (idx < n)
    rows = torch.where(hit[..., None], wl[idx.clamp(0, n - 1)], 0.0)
    parts = [Partial() if p == Shard(0) else Shard(2) if p == Shard(1) else Replicate()
             for p in w.placements]
    rows = DTensor.from_local(rows, mesh, parts, run_check=False)
    rows = rows.redistribute(mesh, [Replicate()] * mesh.ndim)
    return rows.redistribute(mesh, tokens.placements)


def _embed_tokens(cfg, params, tokens):
    x = _lookup(params["embed"], tokens)
    if cfg.scale_embeds:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def _embed(cfg, params, tokens, vision_embeds=None):
    """The full sequence's embeddings: tokens, the vision prefix, and the
    sinusoid positions of an enc-dec decoder."""
    x = _embed_tokens(cfg, params, tokens)
    if cfg.vision_tokens and vision_embeds is not None:
        # VLM: image patch embeddings occupy the first vision-token slots
        VT = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, VT:]], dim=1)
    if cfg.is_encdec and cfg.rope_type == "none":
        x = x + sinusoid_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    return x


def _logits(cfg, params, x):
    """The head product; on a mesh its bf16 copy gathered over the FSDP
    axis (``_wc``'s layout), the vocab split over ``model``."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return project(x, constrain(head_weight(cfg, params).to(x.dtype), (None, "vocab")))


def forward(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor, *,
            vision_embeds: Optional[torch.Tensor] = None,
            mrope_pos: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            impl: str = "kernel", remat: bool = False,
            return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B, S, V), the MoE aux loss
    summed over layers, a float32 scalar).

    ``return_hidden=True`` returns the final-norm hidden states (B, S, d)
    in place of the logits: the training loss then never holds the
    (B, S, V) logits at once (``train.step``).  ``remat=True`` runs each
    pass over the layer plan (the body of the JAX package's ``lax.scan``)
    under ``torch.utils.checkpoint``: the backward pass recomputes it from
    its inputs and nothing inside is kept (``nothing_saveable``)."""
    B, S = tokens.shape
    x = _embed(cfg, params, tokens, vision_embeds)
    positions = torch.arange(S, device=tokens.device)
    enc_out = encode(cfg, params, frames, impl=impl) if cfg.is_encdec else None
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    plan = cfg.layer_plan()
    slots = [layers(slot, cfg.n_blocks) for slot in params["blocks"]]

    def block(blk, x, aux):
        x = constrain(x, ("batch", "seq", None))  # keep batch sharded in-loop
        for i, (mixer, ffn) in enumerate(plan):
            sp = slots[i][blk]
            if mixer == "attn":
                x, _ = attn_full(cfg, sp["mixer"], x, positions=positions,
                                 mrope_pos=mrope_pos, impl=impl)
                if cfg.is_encdec:
                    xkv = _build_xkv(cfg, sp["xattn"], enc_out)
                    x = xattn_full(cfg, sp["xattn"], x, xkv, impl=impl)
            else:
                x, _ = mamba_full(cfg, sp["mixer"], x, impl=impl)
            x, aux = _ffn(cfg, ffn, sp.get("ffn"), x, aux)
        return x, aux

    for blk in range(cfg.n_blocks):
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(block, blk, x, aux,
                                                       use_reentrant=False)
        else:
            x, aux = block(blk, x, aux)
    if return_hidden:
        return rms_norm(x, params["final_norm"], cfg.norm_eps), aux
    return _logits(cfg, params, x), aux


def head_weight(cfg: ModelConfig, params: PyTree) -> torch.Tensor:
    """(d, V) LM-head weight (the transposed embedding when tied)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def prefill(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor, *,
            vision_embeds: Optional[torch.Tensor] = None,
            mrope_pos: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            impl: str = "kernel", cache_dtype=None) -> Tuple[torch.Tensor, PyTree]:
    """Process the whole prompt; returns (last-token logits (B, 1, V), the
    decode cache).  The cache length equals the prompt length
    (ring-truncated to the sliding window when the arch uses one); enc-dec
    archs encode ``frames`` and keep each layer's cross-KV in the cache.
    The cache is in ``cache_dtype``, by default the activation dtype
    (``ACT_DTYPE`` when called)."""
    B, S = tokens.shape
    cache_dtype = cache_dtype or ACT_DTYPE
    x = _embed(cfg, params, tokens, vision_embeds)
    positions = torch.arange(S, device=tokens.device)
    enc_out = encode(cfg, params, frames, impl=impl) if cfg.is_encdec else None
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    plan = cfg.layer_plan()
    W = cfg.sliding_window
    per_layer: List[List[Dict[str, torch.Tensor]]] = [[] for _ in plan]
    slots = [layers(slot, cfg.n_blocks) for slot in params["blocks"]]
    for blk in range(cfg.n_blocks):
        x = constrain(x, ("batch", "seq", None))
        for i, (mixer, ffn) in enumerate(plan):
            sp = slots[i][blk]
            if mixer == "attn":
                x, (k, v) = attn_full(cfg, sp["mixer"], x, positions=positions,
                                      mrope_pos=mrope_pos, impl=impl)
                if W and S > W:
                    # keep the trailing window, rolled so that absolute
                    # position p lives at index p % W (ring layout)
                    k, v = _ring_window(k, W), _ring_window(v, W)
                slot_cache = {"k": k.to(cache_dtype), "v": v.to(cache_dtype)}
                if cfg.is_encdec:
                    xk, xv = _build_xkv(cfg, sp["xattn"], enc_out)
                    x = xattn_full(cfg, sp["xattn"], x, (xk, xv), impl=impl)
                    slot_cache["xk"] = xk.to(cache_dtype)
                    slot_cache["xv"] = xv.to(cache_dtype)
            else:
                x, mc = mamba_full(cfg, sp["mixer"], x, return_cache=True, impl=impl)
                slot_cache = {"conv": mc.conv.to(cache_dtype), "ssm": mc.ssm}
            x, aux = _ffn(cfg, ffn, sp.get("ffn"), x, aux)
            per_layer[i].append(slot_cache)
    cache = [{k: torch.stack([c[k] for c in cs]) for k in cs[0]} for cs in per_layer]
    return _logits(cfg, params, x[:, -1:]), cache


def _ring_window(k: torch.Tensor, W: int) -> torch.Tensor:
    """The trailing ``W`` rows of (B, S, KV, Dh) rolled so that absolute
    position p sits at index p % W.  On a mesh each rank rolls its own
    whole sequences (no sharding rule runs)."""
    S = k.shape[1]
    if isinstance(k, DTensor):
        rows = batch_rows(k)
        local = _ring_window(k.redistribute(k.device_mesh, rows).to_local(), W)
        return DTensor.from_local(local, k.device_mesh, rows, run_check=False)
    return torch.roll(k[:, -W:], (S - W) % W, dims=1)


def decode_step(cfg: ModelConfig, params: PyTree, cache: PyTree, token: torch.Tensor,
                pos) -> Tuple[torch.Tensor, PyTree]:
    """One decode step.  token: (B, 1) integer; pos: int or (B,) absolute
    positions.  Returns (logits (B, 1, V), the cache), the cache updated
    in place.  mrope models rotate all three streams by ``pos``; enc-dec
    models attend to the cross-KV in the cache."""
    B = token.shape[0]
    if not isinstance(pos, DTensor):
        pos = torch.as_tensor(pos, device=token.device).to(torch.int64).expand(B)
    x = _embed_tokens(cfg, params, token)
    if cfg.is_encdec and cfg.rope_type == "none":
        # sinusoid positions: add each sequence's pos-th row
        x = x + sinusoid_rows(pos, cfg.d_model).to(x.dtype)[:, None, :]
    plan = cfg.layer_plan()
    slots = [layers(slot, cfg.n_blocks) for slot in params["blocks"]]
    caches = [layers(slot, cfg.n_blocks) for slot in cache]
    for blk in range(cfg.n_blocks):
        x = constrain(x, ("batch", "seq", None))
        for i, (mixer, ffn) in enumerate(plan):
            sp = slots[i][blk]
            ci = caches[i][blk]
            if mixer == "attn":
                x, _ = attn_decode(cfg, sp["mixer"], x, ci, pos=pos)
                if cfg.is_encdec:
                    x = xattn_decode(cfg, sp["xattn"], x, (ci["xk"], ci["xv"]))
            else:
                mc = mamba_lib.MambaCache(conv=ci["conv"], ssm=ci["ssm"])
                x, mc = mamba_decode_sub(cfg, sp["mixer"], x, mc)
                if mc.ssm is not ci["ssm"]:  # on a mesh it was stepped in place
                    ci["conv"].copy_(mc.conv)
                    ci["ssm"].copy_(mc.ssm)
            x, _ = _ffn(cfg, ffn, sp.get("ffn"), x, None)
    return _logits(cfg, params, x), cache
