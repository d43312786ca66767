"""Qwen2-VL-2B backbone — M-RoPE, GQA kv=2; vision frontend stubbed.

[arXiv:2409.12191; hf] — ``input_specs()`` provides precomputed patch
embeddings as the image prefix; M-RoPE position ids cover (t, h, w).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    rope_type="mrope",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    vision_tokens=1024,   # stubbed 32x32-patch image prefix
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B",
))
