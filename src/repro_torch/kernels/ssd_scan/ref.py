"""Plain PyTorch versions of the Mamba-2 SSD (state-space dual) scan (the
port's ``src/repro/kernels/ssd_scan/ref.py``).

Recurrence (per batch b, head h; scalar decay per head):
    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * B_t x_t^T      h: (N, P)
    y_t = C_t^T h_t                                          y: (P,)

* ``ssd_sequential``: a direct loop over time (slow, exact oracle).
* ``ssd_chunked``: the SSD chunked algorithm [arXiv:2405.21060 §6]:
  intra-chunk quadratic term + inter-chunk state pass; the math the CUDA
  kernel ``csrc/ssd_scan.cu`` implements, and its plain version.
* ``ssd_decode_step``: one token against a carried state.

Shapes: x (B,S,H,P); dt (B,S,H); A (H,); Bm/Cm (B,S,G,N) with H % G == 0.
Returns (y (B,S,H,P) in x's dtype, final_state (B,H,N,P) float32).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _expand_groups(Bm: torch.Tensor, H: int) -> torch.Tensor:
    """(B,S,G,N) -> (B,S,H,N) by repeating each group over its heads."""
    return torch.repeat_interleave(Bm, H // Bm.shape[2], dim=2)


def ssd_sequential(x, dt, A, Bm, Cm, h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Bh = _expand_groups(Bm.float(), H)
    Ch = _expand_groups(Cm.float(), H)
    xf, dtf, Af = x.float(), dt.float(), A.float()
    h = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af)[..., None, None]  # (B,H,1,1)
        h = h * decay + torch.einsum("bhn,bhp->bhnp", Bh[:, t] * dtf[:, t, :, None], xf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], h))
    y = torch.stack(ys, dim=1)  # (B,S,H,P)
    return y.to(x.dtype), h


def ssd_chunked(x, dt, A, Bm, Cm, h0: Optional[torch.Tensor] = None, *,
                chunk: int = 128, compute_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """y in x's dtype; every intermediate and the final state in
    ``compute_dtype`` (float64 gives an oracle for the float32 rounding)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    assert S % chunk == 0, (S, chunk)
    nc, Q = S // chunk, chunk

    xf = x.to(compute_dtype).reshape(B, nc, Q, H, P)
    dtf = dt.to(compute_dtype).reshape(B, nc, Q, H)
    Af = A.to(compute_dtype)
    Bh = _expand_groups(Bm.to(compute_dtype), H).reshape(B, nc, Q, H, N)
    Ch = _expand_groups(Cm.to(compute_dtype), H).reshape(B, nc, Q, H, N)

    a = dtf * Af  # (B,nc,Q,H) log-decay per step (<= 0)
    cum = torch.cumsum(a, dim=2)  # alpha_i within chunk (inclusive)
    total = cum[:, :, -1]  # (B,nc,H)

    # intra-chunk: M[i,j] = exp(alpha_i - alpha_j) for j <= i, masked
    # BEFORE the exp (j > i could overflow)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Qi,Qj,H)
    li = torch.arange(Q, device=x.device)
    causal = (li[:, None] >= li[None, :])[None, None, ..., None]
    M = torch.exp(torch.where(causal, diff, -torch.inf))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)  # C_i . B_j
    xdt = xf * dtf[..., None]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M * scores, xdt)

    # chunk summaries -> inter-chunk recurrence
    w = torch.exp(total[:, :, None] - cum)  # (B,nc,Q,H)
    S_c = torch.einsum("bcjhn,bcjhp->bchnp", Bh * (w * dtf)[..., None], xf)

    h = (torch.zeros((B, H, N, P), dtype=compute_dtype, device=x.device)
         if h0 is None else h0.to(compute_dtype))
    h_in = []
    for c in range(nc):
        h_in.append(h)  # state entering chunk c
        h = h * torch.exp(total[:, c])[..., None, None] + S_c[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B,nc,H,N,P)

    y_inter = torch.einsum("bcihn,bchnp->bcihp", Ch * torch.exp(cum)[..., None], h_in)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y.to(x.dtype), h


def ssd_decode_step(x, dt, A, Bm, Cm, h) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token: x (B,H,P); dt (B,H); Bm/Cm (B,G,N); h (B,H,N,P)."""
    H, G = x.shape[1], Bm.shape[1]
    Bh = torch.repeat_interleave(Bm.float(), H // G, dim=1)
    Ch = torch.repeat_interleave(Cm.float(), H // G, dim=1)
    dtf = dt.float()
    decay = torch.exp(dtf * A.float())[..., None, None]
    h = h.float() * decay + torch.einsum("bhn,bhp->bhnp", Bh * dtf[..., None], x.float())
    y = torch.einsum("bhn,bhnp->bhp", Ch, h)
    return y.to(x.dtype), h
