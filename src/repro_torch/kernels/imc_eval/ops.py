"""The imc_eval kernel's wrapper and the full EvalResult built on it.

``imc_eval_multi`` takes a batch of populations and workload sets and
returns the three layer sums, ``(B, W, P)`` each:

* on CPU tensors it runs the plain version (``ref.eval_workloads``);
* on CUDA tensors it calls the operator ``repro_torch::imc_eval``
  (``IMC_EVAL``), whose CUDA implementation (``csrc/imc_eval_op.cpp``)
  launches ``csrc/imc_eval.cu`` once for all W workloads of all B
  searches, or raises.  There is no fallback.  Its fake implementation
  (``_fake``) gives the sums' shape under ``FakeTensorMode`` and raises
  the wrapper's shape errors (``check``), which the CUDA implementation
  raises word for word.

``imc_eval_sums`` is the same call with the three sums stacked
``(3, B, W, P)``, the operator's own output.  ``imc_eval_multi.launches``
counts kernel launches of both (never plain runs, and never a fake call).
``evaluate_designs_kernel_arrays`` is the drop-in for
``imc.cost.evaluate_designs_arrays`` behind ``backend="kernel"``: the
design stack (``design_stack``), one launch over the flattened batch
(``layer_sums``), and the design-global epilogue (``kernel_epilogue``:
leakage, area, fits, util, V/f validity) in PyTorch, as in the JAX
package's ``kernels/imc_eval/ops.py``.  The three pieces are public so
that a captured GA generation (``core.ga.CapturePlan``) can replay the
first and the last as CUDA graphs and make the launch between them as
an eager operator call.  ``evaluate_designs_kernel`` is the
``WorkloadSet`` form, the drop-in for ``imc.cost.evaluate_designs``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.imc.cost import DesignArrays, EvalResult, area_mm2, design_valid
from repro_torch.imc.tech import TECH, TechParams
from repro_torch.kernels import _build, _launch
from repro_torch.kernels.imc_eval import ref
from repro_torch.workloads.pack import WorkloadSet

_NAME = "imc_eval"
# TechParams -> its constants; keyed by the whole value, every field
_CONSTS: Dict[TechParams, Tuple[float, ...]] = {}
_LIB = None


def build_consts(tech: TechParams) -> Tuple[float, ...]:
    """Technology constants in the kernel's ``Const`` order (float32)."""
    return _launch.float32_values([
        tech.input_bits, tech.weight_bits, tech.adc_share,
        tech.router_flit_bytes, tech.dram_bw_bytes_per_ns, tech.g_avg_s,
        tech.adc_energy_pj, tech.dac_energy_pj, tech.router_energy_pj_per_byte,
        tech.tile_buf_energy_pj_per_byte + tech.glb_energy_pj_per_byte,
        tech.dram_energy_pj_per_byte,
    ])


def consts(tech: TechParams) -> Tuple[float, ...]:
    """``build_consts(tech)``, built once per distinct ``tech``."""
    hit = _CONSTS.get(tech)
    if hit is None:
        hit = _CONSTS[tech] = build_consts(tech)
    return hit


def check(designs: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor) -> None:
    """The wrapper's shape and device errors (the operator's too)."""
    if designs.dim() != 3 or designs.shape[-1] != 9:
        raise ValueError(f"designs must be (B, P, 9), got {tuple(designs.shape)}")
    B = designs.shape[0]
    if feats.dim() != 4 or feats.shape[0] != B or feats.shape[-1] != 6:
        raise ValueError(f"feats must be (B, W, L, 6), got {tuple(feats.shape)}")
    W, L = feats.shape[1], feats.shape[2]
    if tuple(mask.shape) != (B, W, L):
        raise ValueError(f"mask must be {(B, W, L)}, got {tuple(mask.shape)}")
    for name, t in (("feats", feats), ("mask", mask)):
        if t.device != designs.device:
            raise ValueError(f"{name} on {t.device}, designs on {designs.device}")


def _fake(designs, feats, mask, consts):
    check(designs, feats, mask)
    B, P, _ = designs.shape
    return designs.new_empty((3, B, feats.shape[1], P), dtype=torch.float32)


IMC_EVAL = _launch.define(
    "imc_eval(Tensor designs, Tensor feats, Tensor mask, float[] consts) -> Tensor", _fake)


def _lib():
    """The kernel library (its queries); loading it registers the
    operator's CUDA implementation."""
    global _LIB
    if _LIB is None:
        lib = _build.load(_NAME)
        i = ctypes.c_int
        lib.imc_eval_lanes.argtypes = [i, i, i]
        lib.imc_eval_lanes.restype = i
        _LIB = lib
    return _LIB


def lanes_per_design(B: int, P: int, W: int) -> int:
    """Lanes the kernel gives each (design, workload, search) at this size."""
    return _lib().imc_eval_lanes(B, P, W)


def imc_eval_sums(
    designs: torch.Tensor,  # (B, P, 9) float32
    feats: torch.Tensor,  # (B, W, L, 6) float32
    mask: torch.Tensor,  # (B, W, L) bool
    *,
    tech: TechParams = TECH,
) -> torch.Tensor:
    """Layer sums (energy, latency, demand) stacked, (3, B, W, P)."""
    dev = designs.device
    if dev.type == "cpu":
        return torch.stack(ref.eval_workloads(designs, feats, mask, tech))
    if dev.type != "cuda":
        raise ValueError(f"imc_eval_multi: unsupported device {dev}")
    real = _launch.is_real(designs)
    if real:
        _lib()
    out = IMC_EVAL(designs, feats, mask, consts(tech))
    if real:
        imc_eval_multi.launches += 1
    return out


def imc_eval_multi(
    designs: torch.Tensor,  # (B, P, 9) float32
    feats: torch.Tensor,  # (B, W, L, 6) float32
    mask: torch.Tensor,  # (B, W, L) bool
    *,
    tech: TechParams = TECH,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Layer sums (energy, latency, demand), each (B, W, P)."""
    if designs.device.type == "cpu":
        return ref.eval_workloads(designs, feats, mask, tech)
    return imc_eval_sums(designs, feats, mask, tech=tech).unbind(0)


imc_eval_multi.launches = 0


def design_stack(d: DesignArrays) -> torch.Tensor:
    """Decoded designs (..., P) per field -> the kernel's (..., P, 9) rows."""
    return torch.stack(list(d), dim=-1).to(torch.float32)


def layer_sums(designs: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
               tech: TechParams = TECH) -> torch.Tensor:
    """``imc_eval_sums`` over any leading batch: designs (..., P, 9), feats
    (..., W, L, 6), mask (..., W, L) -> (3, prod(...), W, P)."""
    W, L = feats.shape[-3], feats.shape[-2]
    return imc_eval_sums(designs.reshape(-1, *designs.shape[-2:]),
                         feats.reshape(-1, W, L, 6), mask.reshape(-1, W, L), tech=tech)


def kernel_epilogue(d: DesignArrays, sums: torch.Tensor,
                    tech: TechParams = TECH) -> EvalResult:
    """EvalResult (..., P, W) from the designs and their ``layer_sums``."""
    batch = d.rows.shape[:-1]
    W = sums.shape[-2]
    e, l, x = sums.unbind(0)
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


def evaluate_designs_kernel_arrays(
    d: DesignArrays,
    feats: torch.Tensor,  # (..., W, L, 6)
    mask: torch.Tensor,  # (..., W, L)
    tech: TechParams = TECH,
) -> EvalResult:
    """EvalResult (..., P, W) with the layer sums from one kernel launch
    for every workload of every search on CUDA."""
    return kernel_epilogue(d, layer_sums(design_stack(d), feats, mask, tech), tech)


def evaluate_designs_kernel(d: DesignArrays, ws: WorkloadSet, tech: TechParams = TECH
                            ) -> EvalResult:
    """``evaluate_designs_kernel_arrays`` over a workload set, on the
    designs' device."""
    dev = d.rows.device
    return evaluate_designs_kernel_arrays(d, ws.feats.to(dev), ws.mask.to(dev), tech)
