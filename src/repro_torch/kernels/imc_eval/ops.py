"""The imc_eval kernel's wrapper and the full EvalResult built on it.

``imc_eval_multi`` takes a batch of populations and workload sets and
returns the three layer sums, ``(B, W, P)`` each:

* on CPU tensors it runs the plain version (``ref.eval_workloads``);
* on CUDA tensors it launches ``csrc/imc_eval.cu`` once for all W
  workloads of all B searches, or raises.  There is no fallback.

``imc_eval_multi.launches`` counts kernel launches (never plain runs).
``evaluate_designs_kernel_arrays`` is the drop-in for
``imc.cost.evaluate_designs_arrays`` behind ``backend="kernel"``: the
design-global epilogue (leakage, area, fits, util, V/f validity) stays in
PyTorch, as in the JAX package's ``kernels/imc_eval/ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.imc.cost import DesignArrays, EvalResult, area_mm2, design_valid
from repro_torch.imc.tech import TECH, TechParams
from repro_torch.kernels import _build
from repro_torch.kernels.imc_eval import ref

_NAME = "imc_eval"


def _consts(tech: TechParams):
    """Technology constants in the kernel's ``Const`` order."""
    return _build.float_array([
        tech.input_bits, tech.weight_bits, tech.adc_share,
        tech.router_flit_bytes, tech.dram_bw_bytes_per_ns, tech.g_avg_s,
        tech.adc_energy_pj, tech.dac_energy_pj, tech.router_energy_pj_per_byte,
        tech.tile_buf_energy_pj_per_byte + tech.glb_energy_pj_per_byte,
        tech.dram_energy_pj_per_byte,
    ])


def _launcher():
    lib = _build.load(_NAME)
    fn = lib.imc_eval_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                       ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def imc_eval_multi(
    designs: torch.Tensor,  # (B, P, 9) float32
    feats: torch.Tensor,  # (B, W, L, 6) float32
    mask: torch.Tensor,  # (B, W, L) bool
    *,
    tech: TechParams = TECH,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Layer sums (energy, latency, demand), each (B, W, P)."""
    dev = designs.device
    if dev.type == "cpu":
        return ref.eval_workloads(designs, feats, mask, tech)
    if dev.type != "cuda":
        raise ValueError(f"imc_eval_multi: unsupported device {dev}")
    if designs.dim() != 3 or designs.shape[-1] != 9:
        raise ValueError(f"designs must be (B, P, 9), got {tuple(designs.shape)}")
    B, P, _ = designs.shape
    if feats.dim() != 4 or feats.shape[0] != B or feats.shape[-1] != 6:
        raise ValueError(f"feats must be (B, W, L, 6), got {tuple(feats.shape)}")
    W, L = feats.shape[1], feats.shape[2]
    if tuple(mask.shape) != (B, W, L):
        raise ValueError(f"mask must be {(B, W, L)}, got {tuple(mask.shape)}")
    for name, t in (("feats", feats), ("mask", mask)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, designs on {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    d = designs.to(torch.float32).contiguous()
    f = feats.to(torch.float32).contiguous()
    m = mask.to(torch.bool).contiguous()
    out = torch.empty((3, B, W, P), dtype=torch.float32, device=dev)
    consts = _consts(tech)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _launcher()(d.data_ptr(), f.data_ptr(), m.data_ptr(),
                         out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                         B, P, W, L, consts, len(consts), dev.index, stream)
    _build.check(_NAME, rc)
    imc_eval_multi.launches += 1
    return out[0], out[1], out[2]


imc_eval_multi.launches = 0


def evaluate_designs_kernel_arrays(
    d: DesignArrays,
    feats: torch.Tensor,  # (..., W, L, 6)
    mask: torch.Tensor,  # (..., W, L)
    tech: TechParams = TECH,
) -> EvalResult:
    """EvalResult (..., P, W) with the layer sums from ``imc_eval_multi``
    (one launch for every workload of every search on CUDA)."""
    designs = torch.stack(list(d), dim=-1).to(torch.float32)  # (..., P, 9)
    batch = designs.shape[:-2]
    W, L = feats.shape[-3], feats.shape[-2]
    e, l, x = imc_eval_multi(designs.reshape(-1, *designs.shape[-2:]),
                             feats.reshape(-1, W, L, 6),
                             mask.reshape(-1, W, L), tech=tech)
    energy = e.transpose(-1, -2).reshape(*batch, -1, W)  # (..., P, W)
    latency = l.transpose(-1, -2).reshape(*batch, -1, W)
    demand = x.transpose(-1, -2).reshape(*batch, -1, W)

    area = area_mm2(d, tech)  # (..., P)
    energy = energy + tech.leak_mw_per_mm2 * area[..., None] * latency

    capacity = (d.g_per_chip * d.t_per_router * d.c_per_tile).to(torch.float32)
    fits = demand <= capacity[..., None]
    util = demand / capacity[..., None]

    return EvalResult(
        energy_pj=energy,
        latency_ns=latency,
        area_mm2=area,
        fits=fits,
        valid=design_valid(d, tech),
        util=util,
    )
