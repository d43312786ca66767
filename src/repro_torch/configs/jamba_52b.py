"""Jamba-v0.1 (52B) — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf] — period-8 blocks: attention at in-block index 4,
Mamba elsewhere; MoE FFN on odd in-block indices (every 2nd layer).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    topk=2,
    moe_every=2,
    ssm_state=16,           # jamba uses mamba-1 state 16; SSD block reuses it
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    attn_every=8,
    attn_offset=4,
    rope_type="none",       # jamba uses no positional encoding
    source="arXiv:2403.19887; hf:ai21labs/Jamba-v0.1",
))
