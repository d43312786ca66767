"""A serving or training step's inputs for one model (the port's
``input_specs``, ``make_inputs`` and ``default_accum`` of
``src/repro/launch/cells.py``).

The stubbed frontends take synthetic inputs, as in the JAX package:
whisper's conv frontend becomes precomputed frame embeddings (``frames``,
one per decoder position), qwen2-vl's vision tower becomes precomputed
patch embeddings for the first ``vision_tokens`` positions
(``vision_embeds``) with their mrope position streams (``mrope_pos``, the
(t, h, w) streams all equal to the token index).  The rest of the JAX
module (shape cells, meshes, abstract state) belongs to the multi-device
work and has no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig

KINDS = ("train", "prefill", "decode")

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


def input_specs(cfg: ModelConfig, kind: str, batch: int, seq: int
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of each input of a ``kind`` step ("train": ``seq``
    input tokens and their ``seq`` targets; "prefill": the prompt, ``seq``
    tokens; "decode": one new token against a cache of ``seq``).  Train and
    prefill steps also take the model's extras: vision embeddings and
    mrope streams, or encoder frames."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: want one of {KINDS}")
    B, S = batch, seq
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if kind == "train":
        out["inputs"] = ((B, S), torch.int64)
        out["targets"] = ((B, S), torch.int64)
    elif kind == "prefill":
        out["tokens"] = ((B, S), torch.int64)
    if kind != "decode":
        if cfg.vision_tokens:
            out["vision_embeds"] = ((B, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
            out["mrope_pos"] = ((3, B, S), torch.int64)
        if cfg.is_encdec:
            out["frames"] = ((B, S, cfg.d_model), torch.bfloat16)
    else:
        out["token"] = ((B, 1), torch.int64)
        out["pos"] = ((B,), torch.int64)  # per-slot positions (continuous batching)
    return out


def make_inputs(cfg: ModelConfig, kind: str, batch: int, seq: int,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random inputs matching ``input_specs``, drawn from ``generator`` on
    its device: tokens below min(vocab, 1000), embeddings N(0, 0.02^2) in
    bf16, every decode position ``seq - 1``, mrope streams = the token
    index."""
    dev = generator.device
    out = {}
    for name, (shape, dtype) in input_specs(cfg, kind, batch, seq).items():
        if name == "pos":
            out[name] = torch.full(shape, seq - 1, dtype=dtype, device=dev)
        elif name == "mrope_pos":
            out[name] = torch.arange(seq, device=dev).expand(shape).clone()
        elif dtype == torch.int64:
            out[name] = torch.randint(0, min(cfg.vocab_size, 1000), shape,
                                      generator=generator, device=dev)
        else:
            x = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
            out[name] = x.to(dtype) * 0.02
    return out


def default_accum(cfg: ModelConfig, kind: str) -> int:
    """Microbatches per step: ``ACCUM_BY_ARCH`` (default 2) for a train step,
    1 for an inference step."""
    if kind != "train":
        return 1
    return ACCUM_BY_ARCH.get(cfg.name, 2)
