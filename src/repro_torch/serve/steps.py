"""Serving steps: prefill (prompt -> cache) and decode (one token), the
port's ``src/repro/serve/steps.py``.  The engine (``serve/engine.py``)
drives them with continuous batching.

On a mesh (DTensor parameters, inputs and cache, ``launch/cells.build_step``)
a step runs under ``implicit_replication``, as the train step does: plain
tensors the model makes (positions, masks) take part as replicated values.
The launcher enters ``ctx.use_rules``."""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.models import transformer

PyTree = Any


def _scope(batch: Dict[str, torch.Tensor]):
    on_mesh = any(isinstance(v, DTensor) for v in batch.values())
    return implicit_replication() if on_mesh else contextlib.nullcontext()


def make_prefill_step(cfg: ModelConfig, *, impl: str = "kernel") -> Callable:
    """``batch``: ``tokens`` (B, S), and ``vision_embeds`` / ``mrope_pos``
    (VLM) or ``frames`` (enc-dec) where the model takes them."""
    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, PyTree]:
        with _scope(batch):
            return transformer.prefill(cfg, params, batch["tokens"],
                                       vision_embeds=batch.get("vision_embeds"),
                                       mrope_pos=batch.get("mrope_pos"),
                                       frames=batch.get("frames"), impl=impl)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    """The cache is updated in place (the JAX package donates it)."""
    def decode_step(params, cache, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, PyTree]:
        with _scope(batch):
            return transformer.decode_step(cfg, params, cache, batch["token"], batch["pos"])

    return decode_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """(B, S, V) logits -> (B, 1) int32 argmax of the last position (the
    first index among ties, as jnp.argmax)."""
    return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]


def temperature_sample(logits: torch.Tensor, key, temperature: float = 1.0) -> torch.Tensor:
    """(B, S, V) logits -> (B, 1) int32: the argmax of the last position's
    logits over ``temperature`` plus Gumbel noise drawn from the threefry
    ``key`` ((2,) uint32 words), the JAX package's ``temperature_sample``;
    runs on the logits' device."""
    last = logits[:, -1, :]
    g = prng.gumbel(prng.as_key(key, last.device), tuple(last.shape))
    return torch.argmax(last / temperature + g, dim=-1).to(torch.int32)[:, None]
