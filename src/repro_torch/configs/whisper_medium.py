"""Whisper-medium — encoder-decoder; conv frontend stubbed to frame embeddings.

[arXiv:2212.04356] — 24 encoder + 24 decoder layers, d_model=1024, MHA.
The assigned stress shapes (prefill_32k / decode_32k) exceed Whisper's native
1500-frame / 448-token positions; we exercise the *backbone* at those shapes
as specified (frontend is a stub providing precomputed frame embeddings).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,            # decoder layers
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    mlp_act="gelu",
    rope_type="none",       # whisper: sinusoid (enc) + learned (dec) positions
    tie_embeddings=True,
    source="arXiv:2212.04356; hf:openai/whisper-medium",
))
