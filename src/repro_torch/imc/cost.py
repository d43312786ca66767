"""Analytical IMC chip performance model in plain PyTorch (the dense path).

Evaluates a population of chip designs against a set of workloads in one
batch of tensor ops (CIMLoop/NeuroSim-class estimates, closed form):

    E (..., P, W) pJ,  L (..., P, W) ns,  A (..., P) mm^2,
    fits (..., P, W),  valid (..., P)

Leading ``...`` axes are independent searches (the batch axis ``B`` of
the GA); every formula is the JAX package's ``imc/cost.py``, term for
term and in the same association order.  See that module's docstring for
the architecture and what scales with what.

Two numerical rules hold throughout the port:

* A division by a constant is a true division (``_true_div``): PyTorch on
  CUDA turns ``x / python_float`` into ``x * (1 / c)``, which rounds
  differently, so the plain path would not match the kernels bit for bit.
* V/f validity is never recomputed with ``** alpha_power`` per design.
  ``valid_vt_mask`` evaluates the reference formula once, in float32 on
  the CPU, over the (v_op, t_cycle_ns) grid, and every path looks the mask
  up by grid index.  The cell (v_op=0.9, t_cycle=1.0) sits on the
  boundary: float32 gives t_min = 1.0000001 there, so the reference calls
  the nominal design invalid, and any other rounding of ``powf`` could
  flip it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.core import space
from repro_torch.device import resolve_device
from repro_torch.imc.design import DesignArrays
from repro_torch.imc.tech import TECH, TechParams
from repro_torch.workloads.pack import WorkloadSet

__all__ = [
    "DesignArrays", "EvalResult", "area_mm2", "design_valid",
    "evaluate_designs", "evaluate_designs_arrays", "evaluate_one",
    "valid_vt_mask", "vt_valid_from_indices",
]


class EvalResult(NamedTuple):
    energy_pj: torch.Tensor  # (..., P, W)
    latency_ns: torch.Tensor  # (..., P, W)
    area_mm2: torch.Tensor  # (..., P)
    fits: torch.Tensor  # (..., P, W) bool: workload weights resident on chip
    valid: torch.Tensor  # (..., P) bool: design self-consistent (V/f)
    util: torch.Tensor  # (..., P, W) crossbar-capacity utilization


def _true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device (a 0-d tensor on
    ``x``'s device is not a CPU scalar, so CUDA does not take the
    multiply-by-reciprocal shortcut)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` as an IEEE division (``float / tensor`` in PyTorch is
    ``reciprocal(x) * c``)."""
    return torch.full_like(x, c) / x


# (tech, grid token, device) -> (v grid, t grid, (V, Tc) mask)
_VT_CACHE: Dict[tuple, tuple] = {}


def valid_vt_mask(tech: TechParams = TECH) -> torch.Tensor:
    """(V, Tc) bool mask of the reference's ``design_valid`` over the
    (v_op, t_cycle_ns) grid, computed once in float32 on the CPU with the
    reference formula (Python-float ``k``, float32 ``v``)."""
    v = torch.from_numpy(np.asarray(space.SPACE["v_op"], np.float32))[:, None]
    t = torch.from_numpy(np.asarray(space.SPACE["t_cycle_ns"], np.float32))[None, :]
    k = (tech.v_nominal - tech.v_th) ** tech.alpha_power / tech.v_nominal
    t_min = k * v / (v - tech.v_th) ** tech.alpha_power
    return t >= t_min


def _vt_tables(tech: TechParams, device: torch.device):
    key = (tech, space.grid_token(), str(device))
    hit = _VT_CACHE.get(key)
    if hit is None:
        vg = torch.from_numpy(np.asarray(space.SPACE["v_op"], np.float32))
        tg = torch.from_numpy(np.asarray(space.SPACE["t_cycle_ns"], np.float32))
        hit = (vg.to(device), tg.to(device), valid_vt_mask(tech).to(device))
        _VT_CACHE[key] = hit
    return hit


def vt_valid_from_indices(vi: torch.Tensor, ti: torch.Tensor,
                          tech: TechParams = TECH) -> torch.Tensor:
    """Validity of designs given their v_op / t_cycle_ns grid indices."""
    _, _, mask = _vt_tables(tech, vi.device)
    return mask[vi, ti]


def design_valid(d: DesignArrays, tech: TechParams = TECH) -> torch.Tensor:
    """V/f self-consistency (..., P).  Grid values (everything the search
    produces) look the host-built mask up; a value off the grid falls
    back to the alpha-power formula on the tensor's device."""
    vg, tg, mask = _vt_tables(tech, d.v_op.device)
    v = d.v_op.to(torch.float32).contiguous()
    t = d.t_cycle_ns.to(torch.float32).contiguous()
    vi = torch.searchsorted(vg, v).clamp_max(vg.numel() - 1)
    ti = torch.searchsorted(tg, t).clamp_max(tg.numel() - 1)
    on_grid = (vg[vi] == v) & (tg[ti] == t)
    k = (tech.v_nominal - tech.v_th) ** tech.alpha_power / tech.v_nominal
    by_formula = t >= k * v / (v - tech.v_th) ** tech.alpha_power
    return torch.where(on_grid, mask[vi, ti], by_formula)


def area_mm2(d: DesignArrays, tech: TechParams = TECH) -> torch.Tensor:
    """Provisioned chip area (independent of workload)."""
    n_tiles = d.g_per_chip * d.t_per_router
    n_xbars = n_tiles * d.c_per_tile
    xbar = (
        d.rows * d.cols * tech.cell_area_mm2
        + d.rows * tech.driver_area_mm2_per_row
        + (d.cols / tech.adc_share) * tech.adc_area_mm2
    )
    tile_buf = tech.tile_buf_kb / 1024.0 * tech.sram_area_mm2_per_mb
    a = (
        n_xbars * xbar
        + n_tiles * tile_buf
        + d.g_per_chip * tech.router_area_mm2
        + d.glb_mb * tech.sram_area_mm2_per_mb
    )
    return a * 1.10  # global wiring/pads overhead


def evaluate_designs(
    d: DesignArrays, ws: WorkloadSet, tech: TechParams = TECH
) -> EvalResult:
    """Designs (P,) x workloads (W, L, 6), on the designs' device."""
    dev = d.rows.device
    return evaluate_designs_arrays(d, ws.feats.to(dev), ws.mask.to(dev), tech)


def evaluate_designs_arrays(
    d: DesignArrays, feats: torch.Tensor, mask: torch.Tensor,
    tech: TechParams = TECH,
) -> EvalResult:
    """Dense evaluation on raw tensors: design fields (..., P), feats
    (..., W, L, 6), mask (..., W, L) -> metrics (..., P, W)."""
    M, K, N, A_in, A_out, G = feats.to(torch.float32).unsqueeze(-4).unbind(-1)
    mk = mask.to(torch.float32).unsqueeze(-3)  # (..., 1, W, L)

    def b(x):  # (..., P) -> (..., P, 1, 1) against layers (..., 1, W, L)
        return x.to(torch.float32)[..., :, None, None]

    rows, cols = b(d.rows), b(d.cols)
    v_op, bits = b(d.v_op), b(d.bits_cell)
    t_cyc = b(d.t_cycle_ns)
    glb_bytes = b(d.glb_mb) * float(1 << 20)

    cpw = torch.ceil(_rdiv(float(tech.weight_bits), bits))
    xb_layer = torch.ceil(K / rows) * torch.ceil(N * cpw / cols) * G
    demand = (xb_layer * mk).sum(-1)  # (..., P, W)
    capacity = (d.g_per_chip * d.t_per_router * d.c_per_tile).to(torch.float32)
    fits = demand <= capacity[..., None]
    util = demand / capacity[..., None]

    # ---------------- latency ------------------------------------------------
    phases = float(tech.input_bits)
    cyc_per_vec = phases * tech.adc_share
    l_comp = (M * cyc_per_vec * t_cyc * mk).sum(-1)

    bytes_layer = A_in + A_out  # 8-bit activations = 1 B each
    router_bw = b(d.g_per_chip) * tech.router_flit_bytes  # bytes / cycle
    l_comm = (bytes_layer / router_bw * t_cyc * mk).sum(-1)

    spill = torch.clamp_min(bytes_layer - glb_bytes, 0.0)
    l_dram = _true_div((spill * mk).sum(-1), tech.dram_bw_bytes_per_ns)

    latency = l_comp + l_comm + l_dram

    # ---------------- energy -------------------------------------------------
    e_cell = v_op * v_op * tech.g_avg_s * t_cyc * 1e3  # pJ per cell per phase
    cells = K * (N * cpw) * G
    e_analog = (M * phases * cells * e_cell * mk).sum(-1)

    n_col_splits = torch.ceil(N * cpw / cols)
    convs = M * phases * (N * cpw) * G
    e_adc = (convs * tech.adc_energy_pj * mk).sum(-1)
    drives = M * phases * K * n_col_splits * G
    e_dac = (drives * tech.dac_energy_pj * mk).sum(-1)

    e_route = (bytes_layer * tech.router_energy_pj_per_byte * mk).sum(-1)
    e_buf = (
        bytes_layer
        * (tech.tile_buf_energy_pj_per_byte + tech.glb_energy_pj_per_byte)
        * mk
    ).sum(-1)
    e_dram = (spill * tech.dram_energy_pj_per_byte * mk).sum(-1)

    area = area_mm2(d, tech)
    # 1 mW x 1 ns = 1 pJ
    e_leak = tech.leak_mw_per_mm2 * area[..., None] * latency

    energy = e_analog + e_adc + e_dac + e_route + e_buf + e_dram + e_leak

    return EvalResult(
        energy_pj=energy,
        latency_ns=latency,
        area_mm2=area,
        fits=fits,
        valid=design_valid(d, tech),
        util=util,
    )


def evaluate_one(design: Dict[str, float], ws: WorkloadSet,
                 tech: TechParams = TECH, *, device="cuda") -> EvalResult:
    dev = resolve_device(device)
    d = DesignArrays(**{k: torch.tensor([v], dtype=torch.float32, device=dev)
                        for k, v in design.items()})
    return evaluate_designs(d, ws, tech)
