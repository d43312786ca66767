"""Model configuration system (the port's copy of ``src/repro/configs/base.py``).

A ``ModelConfig`` describes a *family* via a layer plan: a repeating period
of (mixer, ffn) sub-layer kinds.  Dense transformers have period 1 =
[("attn", "mlp")]; Mamba-2 is [("mamba", "none")] (the SSD block carries its
own gating).  The fields are the JAX package's, so a configuration carried
across compares field by field.  The registry holds all ten of the JAX
package's configurations: every one exports its layers as an IMC workload
(``workloads/lm.py``) and runs in ``models.transformer``.  The four
shape cells (``ALL_SHAPES``) are the JAX package's, and each configuration
names the ones it runs (``supported_shapes``) and skips (``shape_skips``):
``launch/cells.py`` and ``launch/dryrun.py`` read them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Tuple

MIXER_KINDS = ("attn", "mamba")
FFN_KINDS = ("mlp", "moe", "none")


@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: a step of ``kind`` ("train" | "prefill" |
    "decode") over ``global_batch`` sequences of ``seq_len``."""

    name: str
    seq_len: int
    global_batch: int
    kind: str


# The four assigned shape cells (identical across LM archs).
TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- attention / embedding details -------------------------------------
    mlp_act: str = "silu"  # "silu" (SwiGLU) | "gelu" (GeGLU)
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_type: str = "rope"  # "rope" | "mrope" | "none"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0  # 0 = full attention
    logit_softcap: float = 0.0
    scale_embeds: bool = False  # gemma: multiply embeddings by sqrt(d_model)

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    topk: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    moe_d_ff: int = 0

    # --- SSM (Mamba-2 / SSD) -------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    attn_every: int = 0
    attn_offset: int = 4

    # --- encoder-decoder / VLM -----------------------------------------------
    encoder_layers: int = 0
    vision_tokens: int = 0

    source: str = ""

    # ------------------------------------------------------------------ derived
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def moe_d_ff_(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """True if decode at 500k is sub-quadratic / bounded-memory: SSM
        state is O(1), hybrids attend in 1/attn_every layers, and a sliding
        window bounds the cache.  Pure full-attention archs skip
        ``long_500k``."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def supported_shapes(self) -> List[ShapeSpec]:
        return [s for s in ALL_SHAPES
                if s.name != "long_500k" or self.supports_long_context]

    def shape_skips(self) -> List[Tuple[str, str]]:
        """(shape, reason) pairs for cells that are intentionally not run
        (the JAX package's reasons, word for word)."""
        if self.supports_long_context:
            return []
        return [("long_500k",
                 "pure full-attention arch: O(S) KV cache at 524k infeasible; "
                 "needs sub-quadratic attention (see DESIGN.md §4)")]

    def layer_plan(self) -> List[Tuple[str, str]]:
        """The repeating (mixer, ffn) period; len divides n_layers."""
        if self.family == "ssm":
            return [("mamba", "none")]
        if self.family == "hybrid":
            assert self.attn_every > 0
            plan = []
            for i in range(self.attn_every):
                mixer = "attn" if i == self.attn_offset % self.attn_every else "mamba"
                ffn = ("moe" if (self.n_experts and i % self.moe_every == self.moe_every - 1)
                       else "mlp")
                plan.append((mixer, ffn))
            return plan
        if self.n_experts and self.moe_every == 1:
            return [("attn", "moe")]
        if self.n_experts:
            return [("attn", "moe" if i % self.moe_every == self.moe_every - 1 else "mlp")
                    for i in range(self.moe_every)]
        return [("attn", "mlp")]

    @property
    def period(self) -> int:
        return len(self.layer_plan())

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.period == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"period={self.period}")
        return self.n_layers // self.period

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.head_dim_
        n = self.vocab_size * d
        if not self.tie_embeddings:
            n += self.vocab_size * d
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        if self.qkv_bias:
            attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        mlp = 3 * d * self.d_ff
        moe = self.n_experts * 3 * d * self.moe_d_ff_ + d * self.n_experts
        di, ns = self.d_inner, self.ssm_state
        mamba = (d * (2 * di + 2 * self.ssm_groups * ns + self.ssm_heads)
                 + self.ssm_conv * (di + 2 * self.ssm_groups * ns)
                 + 3 * self.ssm_heads + di * d)
        per_layer = {"attn": attn, "mamba": mamba, "mlp": mlp, "moe": moe, "none": 0}
        for mixer, ffn in self.layer_plan():
            n += (per_layer[mixer] + per_layer[ffn] + 2 * d) * self.n_blocks
        if self.is_encdec:
            # encoder self-attn + mlp, plus decoder cross-attn
            n += self.encoder_layers * (attn + mlp + 2 * d)
            n += self.n_layers * (attn + d)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        full_moe = self.n_experts * 3 * self.d_model * self.moe_d_ff_
        act_moe = self.topk * 3 * self.d_model * self.moe_d_ff_
        n_moe_layers = sum(1 for _, f in self.layer_plan() if f == "moe") * self.n_blocks
        return self.param_count() - n_moe_layers * (full_moe - act_moe)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests (the JAX
        package's reduction, field for field)."""
        small = dict(
            n_layers=self.period * 2,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            topk=min(self.topk, 2) if self.topk else 0,
            moe_d_ff=64 if self.n_experts else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            encoder_layers=2 if self.encoder_layers else 0,
            vision_tokens=8 if self.vision_tokens else 0,
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> List[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all() -> None:
    # importing the modules triggers register()
    from repro_torch.configs import (  # noqa: F401
        gemma_7b,
        jamba_52b,
        llama32_1b,
        mamba2_780m,
        mixtral_8x7b,
        qwen2_72b,
        qwen2_vl_2b,
        qwen3_moe_235b,
        whisper_medium,
        yi_9b,
    )
