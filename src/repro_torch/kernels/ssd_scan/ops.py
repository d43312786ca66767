"""The ssd_scan kernel's wrapper: drop-in for ``ref.ssd_chunked`` (G=1).

* On CPU tensors it runs the plain version (``ref.ssd_chunked``).
* On CUDA tensors it launches ``csrc/ssd_scan.cu``, or raises.  There is
  no fallback.  One call runs three kernels back to back on the current
  stream: ``ssd_scan_chunk_state_kernel`` (each chunk's state, on the
  tensor cores), ``ssd_scan_pass_kernel`` (the state pass over chunks)
  and ``ssd_scan_chunk_out_kernel`` (C B^T, C h_in and L x on the tensor
  cores, y written once), with scratch this wrapper allocates.  The
  products take bf16 operands and float32 sums; a float32 operand goes in
  as two bf16 terms, so y is not the plain version's bits: it lies within
  ~1e-5 of the output's scale of it for float32 inputs and within one
  bf16 rounding for bf16 inputs (``tests/test_torch_ssd.py`` emulates the
  arithmetic).  A (batch row, head)'s result does not depend on the rest
  of the call.

``ssd_chunked.launches`` counts wrapper calls that launched the kernel
(never plain runs): one call counts one launch, also when it runs the
three kernels.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd_scan import ref

_NAME = "ssd_scan"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the card's shared memory a block can opt into (H100: 227 KB)
SMEM_LIMIT = 232448


def _lib():
    lib = _build.load(_NAME)
    fn = lib.ssd_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = i
        lib.ssd_scan_smem_bytes.argtypes = [i, i, i, i]
        lib.ssd_scan_smem_bytes.restype = ctypes.c_longlong
        lib.ssd_scan_work_bytes.argtypes = [i, i, i, i, i, i]
        lib.ssd_scan_work_bytes.restype = ctypes.c_longlong
    return lib


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
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm, Cm must share float32 or bfloat16, got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if h0 is not None and tuple(h0.shape) != (B, H, N, P):
        raise ValueError(f"h0 must be {(B, H, N, P)}, got {tuple(h0.shape)}")
    for name, t in (("dt", dt), ("A", A), ("Bm", Bm), ("Cm", Cm), ("h0", h0)):
        if t is not None and t.device != dev:
            raise ValueError(f"{name} on {t.device}, x on {dev}")
    Q = min(chunk, S)
    if S % Q != 0 or Q > 128:
        raise ValueError(f"chunk {Q} must divide S={S} and be at most 128")
    dtype = _DTYPES[x.dtype]
    lib = _lib()
    need = lib.ssd_scan_smem_bytes(N, P, Q, dtype)
    if need > SMEM_LIMIT:
        raise ValueError(f"ssd_scan needs {need} bytes of shared memory at N={N}, "
                         f"P={P}, chunk={Q} ({x.dtype}); the card offers {SMEM_LIMIT}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    xc = x.contiguous()
    dtc = dt.to(torch.float32).contiguous()
    Ac = A.to(torch.float32).contiguous()
    bc = Bm.contiguous()
    cc = Cm.contiguous()
    h0c = None if h0 is None else h0.to(torch.float32).contiguous()
    y = torch.empty_like(xc)
    h = torch.empty((B, H, N, P), dtype=torch.float32, device=dev)
    # scratch: the cumsums, each chunk's state and the entering states' bf16
    # terms
    work = torch.empty(lib.ssd_scan_work_bytes(B, S, H, P, N, Q), dtype=torch.uint8,
                       device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.ssd_scan_launch(
        xc.data_ptr(), dtc.data_ptr(), Ac.data_ptr(), bc.data_ptr(), cc.data_ptr(),
        None if h0c is None else h0c.data_ptr(), y.data_ptr(), h.data_ptr(),
        work.data_ptr(), B, S, H, P, N, Q, dtype, dev.index, stream)
    _build.check(_NAME, rc)
    ssd_chunked.launches += 1
    return y, h


ssd_chunked.launches = 0
