"""(architecture x input-shape) cells: abstract inputs and step builders
(the port's ``src/repro/launch/cells.py``).

A *cell* is one assigned (arch, shape) pair.  For each cell this module
provides

* ``input_specs``  - the (shape, dtype) of every input of its step,
* ``input_pspecs`` - their specs on a mesh (``sharding.input_sharding``),
* ``abstract_params`` / ``abstract_opt_state`` / ``abstract_cache`` - the
  state as tensors on the ``meta`` device (shapes and dtypes, no storage),
* ``build_step``   - the step with its abstract arguments, their
  placements in and out, and which arguments it updates in place,

used alike by the dry-run (``launch/dryrun.py``), ``chip_smoke.py`` and the
tests (which fill the same bundles with real tensors on reduced configs).

The stubbed frontends take synthetic inputs, as in the JAX package:
whisper's conv frontend becomes precomputed frame embeddings (``frames``,
one per decoder position), qwen2-vl's vision tower becomes precomputed
patch embeddings for the first ``vision_tokens`` positions
(``vision_embeds``) with their mrope position streams (``mrope_pos``, the
(t, h, w) streams all equal to the token index).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeSpec, get_config, list_configs
from repro_torch.distributed import ctx as dist_ctx
from repro_torch.distributed import sharding
from repro_torch.models import transformer
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import AdamWState
from repro_torch.serve.steps import make_decode_step, make_prefill_step
from repro_torch.train.step import make_train_step

PyTree = Any
KINDS = ("train", "prefill", "decode")


@dataclasses.dataclass(frozen=True)
class Cell:
    cfg: ModelConfig
    shape: ShapeSpec

    @property
    def name(self) -> str:
        return f"{self.cfg.name}/{self.shape.name}"


def all_cells(arch: Optional[str] = None, shape: Optional[str] = None) -> List[Cell]:
    """Every runnable (arch x shape) cell, honouring documented skips."""
    cells = []
    for a in list_configs() if arch is None else [arch]:
        cfg = get_config(a)
        cells += [Cell(cfg, s) for s in cfg.supported_shapes()
                  if shape is None or s.name == shape]
    return cells


def skipped_cells() -> List[Tuple[str, str, str]]:
    return [(a, s, why) for a in list_configs() for s, why in get_config(a).shape_skips()]


# ---------------------------------------------------------------- input specs
def input_specs(cfg: ModelConfig, shape: ShapeSpec
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each input of one cell's step (the ``batch``
    argument): "train" ``seq_len`` input tokens and their targets;
    "prefill" the prompt; "decode" one new token against a cache of
    ``seq_len`` and each slot's position.  Train and prefill steps also
    take the model's extras: vision embeddings and mrope streams, or
    encoder frames.  Tokens are int64 (the JAX package's int32)."""
    if shape.kind not in KINDS:
        raise ValueError(f"kind {shape.kind!r}: want one of {KINDS}")
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if shape.kind == "train":
        out["inputs"] = ((B, S), torch.int64)
        out["targets"] = ((B, S), torch.int64)
    elif shape.kind == "prefill":
        out["tokens"] = ((B, S), torch.int64)
    else:
        out["token"] = ((B, 1), torch.int64)
        out["pos"] = ((B,), torch.int64)  # per-slot positions (continuous batching)
    if shape.kind != "decode":
        if cfg.vision_tokens:
            out["vision_embeds"] = ((B, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
            out["mrope_pos"] = ((3, B, S), torch.int64)
        if cfg.is_encdec:
            out["frames"] = ((B, S, cfg.d_model), torch.bfloat16)
    return out


def input_pspecs(cfg: ModelConfig, shape: ShapeSpec, mesh) -> Dict[str, Tuple]:
    return sharding.input_sharding(cfg, shape, mesh)


def make_inputs(cfg: ModelConfig, shape: ShapeSpec,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random inputs matching ``input_specs``, drawn from ``generator`` on
    its device: tokens below min(vocab, 1000), embeddings N(0, 0.02^2) in
    bf16, every decode position ``seq_len - 1``, mrope streams = the token
    index."""
    dev = generator.device
    out = {}
    for name, (shp, dtype) in input_specs(cfg, shape).items():
        if name == "pos":
            out[name] = torch.full(shp, shape.seq_len - 1, dtype=dtype, device=dev)
        elif name == "mrope_pos":
            out[name] = torch.arange(shape.seq_len, device=dev).expand(shp).clone()
        elif dtype == torch.int64:
            out[name] = torch.randint(0, min(cfg.vocab_size, 1000), shp,
                                      generator=generator, device=dev)
        else:
            x = torch.randn(shp, generator=generator, dtype=torch.float32, device=dev)
            out[name] = x.to(dtype) * 0.02
    return out


# ------------------------------------------------------------- abstract state
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_params(cfg: ModelConfig, dtype=torch.float32) -> PyTree:
    return transformer.template_structs(cfg, dtype)


def abstract_opt_state(cfg: ModelConfig) -> AdamWState:
    p = abstract_params(cfg, torch.float32)
    return AdamWState(step=_meta((), torch.int32), mu=p,
                      nu=tree_map(lambda t: _meta(t.shape, t.dtype), p))


def abstract_cache(cfg: ModelConfig, shape: ShapeSpec, dtype=transformer.ACT_DTYPE) -> PyTree:
    return [{k: _meta(shp, dt) for k, (shp, dt) in slot.items()}
            for slot in transformer.cache_template(cfg, shape.global_batch, shape.seq_len,
                                                   dtype)]


# ------------------------------------------------------------------ the steps
@dataclasses.dataclass
class StepBundle:
    """Everything needed to run or trace one cell.

    ``args`` are the step's abstract arguments: meta tensors off a mesh,
    DTensors over meta local shards on one.  ``in_placements`` /
    ``out_placements`` mirror the argument and result trees with each
    leaf's DTensor placements (None: a plain tensor, or as computed).
    ``updates_in_place`` names the arguments the step updates in place,
    the counterpart of the JAX bundle's ``donate_argnums``."""

    fn: Callable
    args: Tuple
    in_placements: Tuple
    out_placements: Any
    updates_in_place: Tuple[int, ...]
    mesh: Any = None


# microbatches per train step by architecture, the JAX package's (chosen there
# for its memory dry-runs); every other architecture takes 2
ACCUM_BY_ARCH = {
    "qwen2-72b": 4,
    "jamba-v0.1-52b": 8,
    "qwen3-moe-235b-a22b": 8,
    "gemma-7b": 4,
    "whisper-medium": 4,
    "yi-9b": 4,
}


def default_accum(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """Microbatches per step: ``ACCUM_BY_ARCH`` (default 2) for a train step,
    1 for an inference step."""
    if shape.kind != "train":
        return 1
    return ACCUM_BY_ARCH.get(cfg.name, 2)


def _is_places(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(not isinstance(p, (tuple, list, dict))
                                                      for p in x))


def map_placed(fn: Callable, tree: PyTree, places: PyTree) -> PyTree:
    """``fn(leaf, placements)`` over a tree and its placements tree (dicts,
    lists and NamedTuples; a placements leaf is a tuple of ``Placement``s
    or None)."""
    if _is_places(places):
        return fn(tree, places)
    if isinstance(tree, dict):
        return {k: map_placed(fn, tree[k], places[k]) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_placed(fn, a, b) for a, b in zip(tree, places)))
    return type(tree)(map_placed(fn, a, b) for a, b in zip(tree, places))


def _abstract_dtensor(mesh):
    def one(t, places):
        if places is None:
            return t
        local = dist_ctx.local_shard(t, mesh, places)
        return DTensor.from_local(local, mesh, places, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return one


def place_tree(tree: PyTree, places: PyTree) -> PyTree:
    """Each DTensor leaf redistributed to its placements (a plain leaf, or
    a leaf with None, as it is): the counterpart of a jitted step's
    ``out_shardings``."""
    def one(x, p):
        if p is None or not isinstance(x, DTensor) or tuple(x.placements) == tuple(p):
            return x
        return x.redistribute(x.device_mesh, p)
    return map_placed(one, tree, places)


def build_step(
    cfg: ModelConfig,
    shape: ShapeSpec,
    mesh,
    *,
    remat: bool = True,
    accum: Optional[int] = None,
    sharding_overrides: Optional[Dict[str, Any]] = None,
    seq_axis: Any = "model",
    impl: str = "plain",
) -> StepBundle:
    """Build the step for a cell on a mesh (``None``: meshless).

    train   -> step(params, opt_state, batch) -> (params, opt_state, metrics)
    prefill -> step(params, batch) -> (logits, cache)
    decode  -> step(params, cache, batch) -> (logits, cache)

    ``impl`` is the attention / SSD path of prefill (``"kernel"``: the
    kernels on each rank's local shards on the card); the JAX bundle lowers
    ``attn_impl="jnp"``, so ``"plain"`` is the default, and training takes
    ``"plain"`` only.  On a mesh the step runs under the caller's
    ``ctx.use_rules(mesh, sharding.make_rules(mesh, overrides))``; its
    prefill cache leaves in ``cache_spec``'s placements."""
    if accum is None:
        accum = default_accum(cfg, shape)
    params = abstract_params(cfg)
    batch = {k: _meta(s, dt) for k, (s, dt) in input_specs(cfg, shape).items()}
    if mesh is None:
        pplace = tree_map(lambda _: None, params)
        bplace = dict.fromkeys(batch)
    else:
        tmpl = transformer.param_template(cfg)
        pplace = sharding.params_sharding(cfg, mesh, tmpl, sharding_overrides)
        bplace = sharding.named_sharding_tree(mesh, input_pspecs(cfg, shape, mesh))

    def cache_places():
        if mesh is None:
            return [dict.fromkeys(slot) for slot in abstract_cache(cfg, shape)]
        return sharding.named_sharding_tree(
            mesh, sharding.cache_spec(cfg, shape, mesh, seq_axis=seq_axis))

    def bundle(fn, args, places, out, updates):
        if mesh is not None:
            args = tuple(map_placed(_abstract_dtensor(mesh), a, p)
                         for a, p in zip(args, places))
        return StepBundle(fn=fn, args=args, in_placements=places, out_placements=out,
                          updates_in_place=updates, mesh=mesh)

    if shape.kind == "train":
        train = make_train_step(cfg, remat=remat, accum=accum, impl=impl)

        def step(params, opt_state, batch):  # the step differentiates the masters
            for p in tree_leaves(params):
                p.requires_grad_()
            return train(params, opt_state, batch)

        opt = abstract_opt_state(cfg)
        oplace = AdamWState(step=None, mu=pplace, nu=pplace)
        return bundle(step, (params, opt, batch), (pplace, oplace, bplace),
                      (pplace, oplace, None), (0, 1))

    cplace = cache_places()
    if shape.kind == "prefill":
        prefill = make_prefill_step(cfg, impl=impl)

        def prefill_step(params, batch):
            logits, cache = prefill(params, batch)
            return logits, place_tree(cache, cplace)

        return bundle(prefill_step, (params, batch), (pplace, bplace), (None, cplace), ())

    return bundle(make_decode_step(cfg), (params, abstract_cache(cfg, shape), batch),
                  (pplace, cplace, bplace), (None, cplace), (1,))


def distribute_args(bundle: StepBundle, values: Tuple) -> Tuple:
    """The bundle's arguments from whole values (trees shaped as
    ``bundle.args``, the same on every rank): on a mesh each leaf cut to
    this rank's shard by its placements (``ctx.distribute``, no
    communication); off a mesh the values themselves."""
    if bundle.mesh is None:
        return tuple(values)

    def one(x, places):
        return x if places is None else dist_ctx.distribute(x, bundle.mesh, places)

    return tuple(map_placed(one, v, p) for v, p in zip(values, bundle.in_placements))
