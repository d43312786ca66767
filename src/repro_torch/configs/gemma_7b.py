"""Gemma-7B — dense, GeGLU, head_dim=256 (MHA: kv=16). [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="gelu",           # GeGLU
    tie_embeddings=True,      # gemma ties the LM head
    scale_embeds=True,        # gemma scales embeddings by sqrt(d_model)
    rope_theta=10_000.0,
    source="arXiv:2403.08295; hf:google/gemma-7b",
))
