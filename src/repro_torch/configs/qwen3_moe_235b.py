"""Qwen3-MoE-235B-A22B — 128 experts top-8, fine-grained experts.

[hf:Qwen/Qwen3-235B-A22B family; config per assignment] — d_ff listed is the
per-expert hidden size (fine-grained experts, moe_d_ff = 1536).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    topk=8,
    moe_d_ff=1536,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-235B-A22B",
))
