"""The flash_attention kernel's wrapper, in the model's (B, S, H, D) layout.

* On CPU tensors it runs the plain version (``ref.attention_reference``).
* On CUDA tensors it launches ``csrc/flash_attention.cu``, or raises.
  There is no fallback.  The input dtype picks the kernel: bf16 (the
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
  into a zero-padded layout (D up to a multiple of 8) and runs the same
  kernel, and the output is cut back to D.  Zero columns add nothing to
  q K^T, and the scale stays D**-0.5 of the caller's D.

``flash_attention.launches`` counts kernel launches (never plain runs).
Like the JAX package's wrapper, a non-causal call whose Skv is not a
multiple of its 128-row KV block is refused, so both wrappers accept the
same calls.  The kernel itself masks a ragged last KV tile by position,
and ``ragged_kv=True`` lifts the limit: the models pass it, because the
JAX package's non-causal model calls (whisper's encoder and
cross-attention) run its jnp path, which takes any Skv up to 1024.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.flash_attention import ref

_NAME = "flash_attention"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _launcher():
    fn = _build.load(_NAME).flash_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, i, i, i, i, p]
        fn.restype = i
    return fn


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
    if k.dim() != 4 or k.shape[0] != B or k.shape[-1] != D or v.shape != k.shape:
        raise ValueError(f"k, v must be (B, Skv, KV, D) = {(B, Skv, KV, D)}, got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if KV == 0 or H % KV != 0:
        raise ValueError(f"H={H} must be a multiple of KV={KV}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside 1..{MAX_HEAD_DIM} (the kernel's "
                         f"largest tier; the largest config head_dim is 256)")
    if Skv == 0:
        raise ValueError("flash_attention needs at least one key")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    index = _launch.cuda_index(dev)
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    Dk = D
    if q.dtype == torch.bfloat16 and not _tma_addressable(D, qc, kc, vc):
        Dk = -(-D // 8) * 8
        qc, kc, vc = (_padded(t, Dk) for t in (qc, kc, vc))
    out = torch.empty_like(qc)
    rc = _launcher()(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
                     B, Sq, Skv, H, KV, Dk, D ** -0.5, int(causal), int(window),
                     int(q_offset), _DTYPES[q.dtype], index, _launch.stream(index))
    _build.check(_NAME, rc)
    flash_attention.launches += 1
    return out if Dk == D else out[..., :D].contiguous()


def _tma_addressable(D: int, *ts: torch.Tensor) -> bool:
    """Whether TMA can address these contiguous bf16 tensors as they are:
    rows of D*2 bytes a multiple of 16 and 16-byte aligned bases."""
    return D % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in ts)


def _padded(t: torch.Tensor, Dk: int) -> torch.Tensor:
    """``t`` (..., D) copied into a fresh (..., Dk) tensor, zeros past D."""
    out = torch.zeros((*t.shape[:-1], Dk), dtype=t.dtype, device=t.device)
    out[..., :t.shape[-1]] = t
    return out


flash_attention.launches = 0
