"""The flash_attention kernel's wrapper, in the model's (B, S, H, D) layout.

* On CPU tensors it runs the plain version (``ref.attention_reference``).
* On CUDA tensors it calls the operator ``repro_torch::flash_attention``
  (``FLASH_ATTENTION``), whose CUDA implementation
  (``csrc/flash_attention_op.cpp``) launches ``csrc/flash_attention.cu``,
  or raises.  There is no fallback.  Its fake implementation gives the
  output's shape under ``FakeTensorMode`` and raises the wrapper's shape
  errors (``check``), which the CUDA implementation raises word for word.
  The input dtype picks the kernel: bf16 (the
  serving path) runs ``flash_attention_wgmma_kernel`` (wgmma and TMA; a
  block serves all query heads of one KV head, for one query tile or, in
  a causal call of more tiles than the card has SMs, a pair of them),
  float32 runs ``flash_attention_f32_kernel`` on the CUDA cores.
* Head dims 1..256 (``MAX_HEAD_DIM``).  The JAX package's wrapper takes any
  D (it pads D to a multiple of 128); the port draws its line at 256, the
  largest ``head_dim`` of any config (gemma-7b), because the bf16 kernel's
  tile plan and register budget are sized per head-dim tier (64, 128,
  256).  A larger D raises a ``ValueError`` naming it.
* TMA addresses bf16 tensors with 16-byte aligned bases and row strides
  (``H*D*2`` and ``KV*D*2`` bytes).  Every model shape meets this; a call
  that does not (D not a multiple of 8, or a misaligned view) is copied
  by the CUDA implementation into a zero-padded layout (D up to a
  multiple of 8) and runs the same kernel, and the output is cut back to
  D.  Zero columns add nothing to
  q K^T, and the scale stays D**-0.5 of the caller's D.

``flash_attention.launches`` counts kernel launches (never plain runs, and
never a fake call).
Like the JAX package's wrapper, a non-causal call whose Skv is not a
multiple of its 128-row KV block is refused, so both wrappers accept the
same calls.  The kernel itself masks a ragged last KV tile by position,
and ``ragged_kv=True`` lifts the limit: the models pass it, because the
JAX package's non-causal model calls (whisper's encoder and
cross-attention) run its jnp path, which takes any Skv up to 1024.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.flash_attention import ref

_NAME = "flash_attention"
MAX_HEAD_DIM = 256


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_offset: int) -> None:
    """The wrapper's shape, dtype and device errors (the operator's too)."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, Sq, H, D), got {tuple(q.shape)}")
    B, Sq, H, D = q.shape
    if k.dim() != 4:
        raise ValueError(f"k, v must be (B, Skv, KV, D), got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    _, Skv, KV, _ = k.shape
    if k.shape[0] != B or k.shape[-1] != D or v.shape != k.shape:
        raise ValueError(f"k, v must be (B, Skv, KV, D) = {(B, Skv, KV, D)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if KV == 0 or H % KV != 0:
        raise ValueError(f"H={H} must be a multiple of KV={KV}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside 1..{MAX_HEAD_DIM} (the kernel's "
                         f"largest tier; the largest config head_dim is 256)")
    if Skv == 0:
        raise ValueError("flash_attention needs at least one key")
    if (q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype
            or v.dtype != q.dtype):
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")


def _fake(q, k, v, causal, window, q_offset):
    check(q, k, v, q_offset)
    return q.new_empty(q.shape)


FLASH_ATTENTION = _launch.define(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, int window, int q_offset)"
    " -> Tensor", _fake)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, KV, D)
    v: torch.Tensor,  # (B, Skv, KV, D)
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    ragged_kv: bool = False,
) -> torch.Tensor:
    """Attention output (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    bk = min(128, max(Skv, 8))
    if Skv % bk != 0 and not causal and not ragged_kv:
        raise ValueError("non-causal flash_attention requires Skv to be a "
                         "multiple of the 128-row KV block")
    dev = q.device
    if dev.type == "cpu":
        return ref.attention_reference(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    real = _launch.is_real(q)
    if real:  # its first call builds and loads the libraries
        _build.load(_NAME)
    out = FLASH_ATTENTION(q, k, v, bool(causal), int(window), int(q_offset))
    if real:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
