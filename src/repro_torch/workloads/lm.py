"""LM architectures exported as IMC workloads (the port's
``src/repro/workloads/lm.py``; beyond the paper).

Every *weight* GEMM of a ``ModelConfig`` becomes an IMC layer descriptor
``(M, K, N, A_in, A_out, groups)``, derived from the config that drives the
models, so the workload cannot drift from the model code.

* IMC crossbars hold weights; activation-activation products (attention
  QK^T / PV, SSD state updates) run on the digital periphery and are not
  crossbar layers.
* ``mode="decode"`` exports the per-token serving cost (M=1 per matmul);
  ``mode="prefill"`` a whole sequence (M=seq).
* Mamba blocks export their in and out projections; the 4-tap causal
  depthwise conv stays on the periphery (one crossbar per channel for 4
  weights each would be absurd), unlike MobileNet's wide depthwise convs.
* MoE: every expert's weights are resident (capacity pressure), but only
  ``topk`` experts fire per token, so M scales by topk / n_experts on the
  expert GEMMs.
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba import _dims

Layer = Tuple[int, int, int, int, int, int]


def _gemm(m: int, k: int, n: int, groups: int = 1, m_frac: float = 1.0) -> Layer:
    m_eff = max(1, int(round(m * m_frac)))
    return (m_eff, k, n, m * k, m_eff * n, groups)


def lm_workload(cfg: ModelConfig, *, mode: str = "decode", seq: int = 1) -> List[Layer]:
    """The config's weight GEMMs as IMC layers, block by block in the
    layer plan's order, then the encoder (encoder-decoder configs) and
    the LM head."""
    if mode not in ("decode", "prefill"):
        raise ValueError(f"mode must be 'decode' or 'prefill', got {mode!r}")
    M = 1 if mode == "decode" else seq
    d, Dh = cfg.d_model, cfg.head_dim_
    H, KV = cfg.n_heads, cfg.n_kv_heads

    def attn_layers() -> List[Layer]:
        return [
            _gemm(M, d, H * Dh),  # wq
            _gemm(M, d, KV * Dh),  # wk
            _gemm(M, d, KV * Dh),  # wv
            _gemm(M, H * Dh, d),  # wo
        ]

    def mlp_layers() -> List[Layer]:
        return [_gemm(M, d, cfg.d_ff), _gemm(M, d, cfg.d_ff), _gemm(M, cfg.d_ff, d)]

    def moe_layers() -> List[Layer]:
        f = cfg.moe_d_ff_
        frac = cfg.topk / cfg.n_experts
        out = [_gemm(M, d, cfg.n_experts)]  # router
        for _ in range(cfg.n_experts):
            out += [_gemm(M, d, f, m_frac=frac), _gemm(M, d, f, m_frac=frac),
                    _gemm(M, f, d, m_frac=frac)]
        return out

    def mamba_layers() -> List[Layer]:
        d_inner, _, _, _, _, _, d_in_proj = _dims(cfg)
        return [_gemm(M, d, d_in_proj), _gemm(M, d_inner, d)]  # in_proj, out_proj

    per_layer = {"attn": attn_layers, "mamba": mamba_layers, "mlp": mlp_layers,
                 "moe": moe_layers, "none": lambda: []}
    layers: List[Layer] = []
    for _ in range(cfg.n_blocks):
        for mixer, ffn in cfg.layer_plan():
            layers += per_layer[mixer]()
            if cfg.is_encdec and mixer == "attn":
                layers += attn_layers()  # cross-attention projections
            layers += per_layer[ffn]()
    if cfg.is_encdec:
        for _ in range(cfg.encoder_layers):
            layers += attn_layers() + mlp_layers()
    # LM head (the embedding lookup is a table read, not a GEMM)
    layers.append(_gemm(M, d, cfg.vocab_size))
    return layers
