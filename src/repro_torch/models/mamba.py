"""Mamba-2 (SSD) mixer block: in_proj -> causal depthwise conv -> SSD -> gate
(the port's ``src/repro/models/mamba.py``).

The full-sequence mixer calls ``kernels/ssd_scan/ops.ssd_chunked``: the
CUDA kernel on the card, its plain version on the CPU; ``impl="plain"``
calls the plain chunked scan directly on any device.  The decode step stays
plain PyTorch (``ssd_decode_step``).  On a mesh (DTensor activations) the
full-sequence core runs on each rank's own sequences, and the decode step
on each rank's own sequences and state heads (``_mamba_decode_mesh``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from torch.distributed.tensor import Shard

from repro_torch.distributed.ctx import batch_rows, constrain, local_rows, project, whole
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd
from repro_torch.models.common import rms_norm


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, K-1, conv_ch) trailing conv inputs
    ssm: torch.Tensor  # (B, H, N, P) state


def _dims(cfg):
    d_inner = cfg.d_inner
    G, N = cfg.ssm_groups, cfg.ssm_state
    H, Pd = cfg.ssm_heads, cfg.ssm_head_dim
    conv_ch = d_inner + 2 * G * N
    d_in_proj = 2 * d_inner + 2 * G * N + H
    return d_inner, G, N, H, Pd, conv_ch, d_in_proj


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel K (shift-sum form, K unrolled)."""
    K = w.shape[0]
    S = xBC.shape[1]
    out = torch.zeros_like(xBC)
    for k in range(K):
        shift = K - 1 - k
        seg = F.pad(xBC, (0, 0, shift, 0))[:, :S]
        out = out + seg * w[k]
    return out + b


def _core(cfg, p, zxbcdt: torch.Tensor, impl: str):
    """The conv, the SSD scan and the gated norm of the input projection's
    output: (y (B, S, d_inner), the pre-activation conv inputs, the final
    state)."""
    B, S, _ = zxbcdt.shape
    d_inner, G, N, H, Pd, conv_ch, _ = _dims(cfg)
    z, xBC, dt = torch.split(zxbcdt, [d_inner, conv_ch, H], dim=-1)
    xBC_raw = xBC

    xBC = _causal_conv(xBC, p["conv_w"].to(zxbcdt.dtype), p["conv_b"].to(zxbcdt.dtype))
    xBC = F.silu(xBC)
    xs, Bm, Cm = torch.split(xBC, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, Pd)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())  # (H,)

    scan = ssd.ssd_chunked if impl == "plain" else ssd_ops.ssd_chunked
    y, h = scan(xs, dt, A, Bm, Cm, chunk=min(128, S))
    y = y + xs * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, d_inner)
    y = y * F.silu(z)
    return rms_norm(y, p["norm_w"], cfg.norm_eps), xBC_raw, h


def mamba_mixer(cfg, p, x: torch.Tensor, *, return_cache: bool = False,
                impl: str = "kernel") -> Tuple[torch.Tensor, Optional[MambaCache]]:
    """x: (B, S, d_model).  Full-sequence form (prefill).

    On a mesh (DTensor x) the core runs on each rank's own sequences with
    its parameters whole: the conv's shifts, the split of the conv channels
    into x, B and C (not aligned with a split of the channels) and the
    scan's segment sums then need no sharding rule (torch 2.11's DTensor
    fails to plan the conv's padding); the cache comes from each rank's own
    sequences too, laid out as they are (batch split, whole otherwise)."""
    zxbcdt = project(x, constrain(p["w_in"].to(x.dtype), (None, "ssm_inner")))
    if isinstance(zxbcdt, DTensor):
        mesh, rows = zxbcdt.device_mesh, batch_rows(zxbcdt)
        local = {k: whole(p[k], rows)
                 for k in ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_w")}
        y, xBC_raw, h = _core(cfg, local, zxbcdt.redistribute(mesh, rows).to_local(), impl)
        y, xBC_raw, h = (DTensor.from_local(t, mesh, rows, run_check=False)
                         for t in (y, xBC_raw, h))
    else:
        y, xBC_raw, h = _core(cfg, p, zxbcdt, impl)
    out = project(y, constrain(p["w_out"].to(y.dtype), ("ssm_inner", None)))

    new_cache = None
    if return_cache:
        K = cfg.ssm_conv
        # trailing K-1 *pre-activation* conv inputs
        new_cache = MambaCache(conv=xBC_raw[:, -(K - 1):, :], ssm=h)
    return out, new_cache


def mamba_decode(cfg, p, x: torch.Tensor, cache: MambaCache
                 ) -> Tuple[torch.Tensor, MambaCache]:
    """x: (B, 1, d_model); single-token step with carried conv + ssm state.
    On a mesh: ``_mamba_decode_mesh``."""
    if isinstance(x, DTensor):
        return _mamba_decode_mesh(cfg, p, x, cache)
    B, _, d = x.shape
    d_inner, G, N, H, Pd, conv_ch, _ = _dims(cfg)

    zxbcdt = x[:, 0] @ constrain(p["w_in"].to(x.dtype), (None, "ssm_inner"))  # (B, d_in_proj)
    y, window, h = _decode_core(cfg, p, zxbcdt, cache.conv, cache.ssm)
    out = (y @ constrain(p["w_out"].to(y.dtype), ("ssm_inner", None)))[:, None, :]
    return out, MambaCache(conv=window[:, 1:].to(cache.conv.dtype), ssm=h)


def _decode_core(cfg, p, zxbcdt, conv, ssm, heads=None, gather=None):
    """The conv, one SSD step and the gated norm of the input projection's
    output (B, d_in_proj): (y (B, d_inner), the conv window (B, K, conv_ch),
    the new state).  ``heads``: the slice of SSD heads ``ssm`` holds (all
    by default); ``gather(y)`` makes (B, H_loc, P) whole over the heads."""
    B = zxbcdt.shape[0]
    d_inner, G, N, H, Pd, conv_ch, _ = _dims(cfg)
    dt_ = zxbcdt.dtype
    z, xBC, dt = torch.split(zxbcdt, [d_inner, conv_ch, H], dim=-1)

    w, b = p["conv_w"].to(dt_), p["conv_b"].to(dt_)
    window = torch.cat([conv.to(dt_), xBC[:, None, :]], dim=1)  # (B,K,ch)
    conv_out = torch.einsum("bkc,kc->bc", window, w) + b
    xBC_a = F.silu(conv_out)

    xs, Bm, Cm = torch.split(xBC_a, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B, H, Pd)
    Bm = Bm.reshape(B, G, N)
    Cm = Cm.reshape(B, G, N)
    dtf = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    if heads is None:
        y, h = ssd.ssd_decode_step(xs, dtf, A, Bm, Cm, ssm)
    else:  # this rank's heads, each with its group's B and C
        Bh = torch.repeat_interleave(Bm, H // G, dim=1)[:, heads]
        Ch = torch.repeat_interleave(Cm, H // G, dim=1)[:, heads]
        y, h = ssd.ssd_decode_step(xs[:, heads], dtf[:, heads], A[heads], Bh, Ch, ssm)
        y = gather(y)
    y = y + xs * p["D"].to(y.dtype)[None, :, None]
    y = y.reshape(B, d_inner)
    y = y * F.silu(z)
    return rms_norm(y, p["norm_w"], cfg.norm_eps), window, h


def _mamba_decode_mesh(cfg, p, x: DTensor, cache: MambaCache
                       ) -> Tuple[DTensor, MambaCache]:
    """``mamba_decode`` on DTensors, the cache in its ``cache_spec`` layout
    and updated in place, never moved whole: the state (B, H, N, P) with
    its heads over ``model``, the conv inputs (B, K-1, conv_ch) with their
    channels there when they divide.  Each rank takes its sequences' input
    projection whole (one token: a small gather) and the whole conv window
    of its sequences, steps the state of its own heads, each with its
    group's B and C, gathers the heads' outputs, and writes its own
    channels of the new conv window."""
    mesh, rows = x.device_mesh, batch_rows(x)
    zxbcdt = project(x, constrain(p["w_in"].to(x.dtype), (None, "ssm_inner")))
    zl = zxbcdt.redistribute(mesh, rows).to_local()[:, 0]
    local = {k: whole(p[k], rows)
             for k in ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm_w")}
    conv = cache.conv.redistribute(mesh, batch_rows(cache.conv)).to_local()
    ssm, lo, split = local_rows(cache.ssm, 1)
    heads = slice(lo, lo + ssm.shape[1])
    lay = [Shard(1) if i in split else pl for i, pl in enumerate(batch_rows(cache.ssm))]

    def gather(y):
        y = DTensor.from_local(y, mesh, lay, run_check=False)
        return y.redistribute(mesh, batch_rows(y)).to_local()

    y, window, h = _decode_core(cfg, local, zl, conv, ssm, heads, gather)
    ssm.copy_(h)
    conv_l, c_lo, _ = local_rows(cache.conv, 2)
    conv_l.copy_(window[:, 1:, c_lo:c_lo + conv_l.shape[2]].to(conv_l.dtype))
    y = DTensor.from_local(y[:, None, :], mesh, rows, run_check=False)
    out = project(y, constrain(p["w_out"].to(y.dtype), ("ssm_inner", None)))
    return out, cache
