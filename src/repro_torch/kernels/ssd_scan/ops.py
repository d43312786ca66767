"""The ssd_scan kernel's wrapper: drop-in for ``ref.ssd_chunked`` (G=1).

* On CPU tensors it runs the plain version (``ref.ssd_chunked``).
* On CUDA tensors it calls the operator ``repro_torch::ssd_scan``
  (``SSD_SCAN``), whose CUDA implementation (``csrc/ssd_scan_op.cpp``)
  launches ``csrc/ssd_scan.cu``, or raises.  There is no fallback.  Its
  fake implementation gives the outputs' shapes under ``FakeTensorMode``
  and raises the wrapper's shape errors (``check``), which the CUDA
  implementation raises word for word; only the CUDA implementation
  checks the shared memory a block needs.  One call runs three kernels
  back to back on the current stream: ``ssd_scan_chunk_state_kernel``
  (each chunk's state, on the tensor cores), ``ssd_scan_pass_kernel``
  (the state pass over chunks) and ``ssd_scan_chunk_out_kernel`` (C B^T,
  C h_in and L x on the tensor cores, y written once), with scratch the
  operator allocates.  The
  products take bf16 operands and float32 sums; a float32 operand goes in
  as two bf16 terms, so y is not the plain version's bits: it lies within
  ~1e-5 of the output's scale of it for float32 inputs and within one
  bf16 rounding for bf16 inputs (``tests/test_torch_ssd.py`` emulates the
  arithmetic).  A (batch row, head)'s result does not depend on the rest
  of the call.

``ssd_chunked.launches`` counts wrapper calls that launched the kernel
(never plain runs, never fake calls): one call counts one launch, also
when it runs the three kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.ssd_scan import ref

_NAME = "ssd_scan"


def check(x, dt, A, Bm, Cm, h0, chunk: int) -> None:
    """The wrapper's shape, dtype and device errors (the operator's too)."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, H, P), got {tuple(x.shape)}")
    B, S, H, P = x.shape
    if Bm.dim() != 4 or Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm/Cm must be (B, S, G, N), got {tuple(Bm.shape)} / "
                         f"{tuple(Cm.shape)}")
    if Bm.shape[2] != 1:
        raise ValueError("the ssd_scan kernel is written for one B/C group (G=1)")
    N = Bm.shape[-1]
    if tuple(dt.shape) != (B, S, H) or tuple(A.shape) != (H,):
        raise ValueError(f"dt must be {(B, S, H)} and A {(H,)}, got "
                         f"{tuple(dt.shape)} / {tuple(A.shape)}")
    if (x.dtype not in (torch.float32, torch.bfloat16) or Bm.dtype != x.dtype
            or Cm.dtype != x.dtype):
        raise ValueError(f"x, Bm, Cm must share float32 or bfloat16, got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if h0 is not None and tuple(h0.shape) != (B, H, N, P):
        raise ValueError(f"h0 must be {(B, H, N, P)}, got {tuple(h0.shape)}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("h0", h0)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    Q = min(chunk, S)
    if Q <= 0 or S % Q != 0 or Q > 128:
        raise ValueError(f"chunk {Q} must divide S={S} and be at most 128")


def _fake(x, dt, A, Bm, Cm, h0, chunk):
    check(x, dt, A, Bm, Cm, h0, chunk)
    B, S, H, P = x.shape
    return (x.new_empty(x.shape),
            x.new_empty((B, H, Bm.shape[-1], P), dtype=torch.float32))


SSD_SCAN = _launch.define(
    "ssd_scan(Tensor x, Tensor dt, Tensor A, Tensor Bm, Tensor Cm, Tensor? h0, int chunk)"
    " -> (Tensor, Tensor)", _fake)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) post-softplus
    A: torch.Tensor,  # (H,)
    Bm: torch.Tensor,  # (B, S, G, N)
    Cm: torch.Tensor,  # (B, S, G, N)
    h0: Optional[torch.Tensor] = None,  # (B, H, N, P)
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, H, P) in x's dtype, final state (B, H, N, P) float32)."""
    dev = x.device
    if dev.type == "cpu":
        return ref.ssd_chunked(x, dt, A, Bm, Cm, h0, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_chunked: unsupported device {dev}")
    real = _launch.is_real(x)
    if real:  # its first call builds and loads the libraries
        _build.load(_NAME)
    y, h = SSD_SCAN(x, dt, A, Bm, Cm, h0, int(chunk))
    if real:
        ssd_chunked.launches += 1
    return y, h


ssd_chunked.launches = 0
