"""The ga_gen_step kernel's wrapper: one whole GA generation on the
factorized tables with the indexed objective, for B searches at once.

``ga_gen_step(pop, scores, u, ctx)`` with ``ctx = (tables, kind, area)``
returns ``(new_pop, new_scores, children, child_scores)``:

* on CPU tensors it runs the plain version (``ref.ga_gen_step_ref``);
* on CUDA tensors it launches ``csrc/ga_gen_step.cu`` once (one block per
  search) or raises.  There is no fallback.

``ga_gen_step.launches`` counts kernel launches.  The engine attaches this
function as the ``gen_step`` of its table-backend callback, so on the
card every generation of ``backend="table"`` runs through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.core import space
from repro_torch.core.ga import GENE_MAX, MUT_ETA, SBX_ETA, SBX_PROB, block_layout
from repro_torch.imc.cost import valid_vt_mask
from repro_torch.imc.tables import WorkloadTables
from repro_torch.imc.tech import TECH, TechParams
from repro_torch.kernels import _build
from repro_torch.kernels.ga_gen_step.ref import ga_gen_step_ref

_NAME = "ga_gen_step"
_GRID_ARGS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _consts(tech: TechParams, sbx_prob: float, n_genes: int):
    """float32 constants in the kernel's ``Const`` order, each the value
    PyTorch uses for the same Python scalar in the plain version."""
    return _build.float_array([
        sbx_prob, 1.0 / n_genes, GENE_MAX,
        float(tech.input_bits), float(tech.weight_bits),
        float(tech.input_bits) * tech.adc_share,
        tech.router_flit_bytes, tech.dram_bw_bytes_per_ns, tech.g_avg_s,
        tech.adc_energy_pj, tech.dac_energy_pj, tech.router_energy_pj_per_byte,
        tech.tile_buf_energy_pj_per_byte + tech.glb_energy_pj_per_byte,
        tech.dram_energy_pj_per_byte,
        tech.cell_area_mm2, tech.driver_area_mm2_per_row, tech.adc_share,
        tech.adc_area_mm2, tech.tile_buf_kb / 1024.0 * tech.sram_area_mm2_per_mb,
        tech.router_area_mm2, tech.sram_area_mm2_per_mb, tech.leak_mw_per_mm2,
        1.10, 1e3,
    ])


def _grid_args(tech: TechParams, dev: torch.device):
    """(grids (9, Gmax) f32, sizes (9,) i32, V/f mask (V, Tc) u8) on dev."""
    key = (tech, space.grid_token(), str(dev))
    hit = _GRID_ARGS.get(key)
    if hit is None:
        grids, sizes = space.padded_grids(dev)
        hit = (grids.contiguous(), sizes.to(torch.int32).contiguous(),
               valid_vt_mask(tech).to(torch.uint8).to(dev).contiguous())
        _GRID_ARGS[key] = hit
    return hit


def _lib():
    lib = _build.load(_NAME)
    if lib.ga_gen_step_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ga_gen_step_launch.argtypes = (
            [p] * 19 + [i] * 9 + [ctypes.POINTER(ctypes.c_float), i, i, p])
        lib.ga_gen_step_launch.restype = i
        lib.ga_gen_step_smem_bytes.argtypes = [i] * 6
        lib.ga_gen_step_smem_bytes.restype = ctypes.c_longlong
        lib.ga_gen_step_max_smem_bytes.argtypes = [i]
        lib.ga_gen_step_max_smem_bytes.restype = i
    return lib


def ga_gen_step(pop: torch.Tensor, scores: torch.Tensor, u: torch.Tensor,
                ctx, *, tech: TechParams = TECH, sbx_prob: float = SBX_PROB,
                sbx_eta: float = SBX_ETA, mut_eta: float = MUT_ETA):
    """pop (B, P, 9), scores (B, P), u (B, tot), ctx = (tables with (B, W,
    ...) leaves, kind (B,), area (B,)) -> (new_pop, new_scores, children,
    child_scores)."""
    tables, kind, area = ctx
    dev = pop.device
    if dev.type == "cpu":
        return ga_gen_step_ref(pop, scores, u, tables, kind, area, tech=tech,
                               sbx_prob=sbx_prob, sbx_eta=sbx_eta, mut_eta=mut_eta)
    if dev.type != "cuda":
        raise ValueError(f"ga_gen_step: unsupported device {dev}")
    if sbx_eta != 3.0 or mut_eta != 3.0:
        raise ValueError("the ga_gen_step kernel implements eta = 3 only "
                         f"(got sbx_eta={sbx_eta}, mut_eta={mut_eta})")
    B, P, n = pop.shape
    if n != space.N_GENES:
        raise ValueError(f"pop must be (B, P, {space.N_GENES}), got {tuple(pop.shape)}")
    tot = block_layout(P, n).tot
    if tuple(scores.shape) != (B, P) or tuple(u.shape) != (B, tot):
        raise ValueError(f"scores {tuple(scores.shape)} / u {tuple(u.shape)} do "
                         f"not match (B, P) = {(B, P)}, tot = {tot}")
    W = tables.demand.shape[1]
    R, C, Bc = (int(s) for s in tables.demand.shape[2:])
    Gn = int(tables.spill.shape[-1])
    gs = space.GRID_SIZES
    if (R, C, Bc, Gn) != (int(gs[0]), int(gs[1]), int(gs[6]), int(gs[8])):
        raise ValueError("tables were built for another grid than the active one")
    for name, leaf in zip(WorkloadTables._fields, tables):
        if leaf.shape[:2] != (B, W) or leaf.device != dev:
            raise ValueError(f"table {name}: {tuple(leaf.shape)} on {leaf.device}, "
                             f"expected leading {(B, W)} on {dev}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    lib = _lib()
    with torch.cuda.device(dev):
        smem = lib.ga_gen_step_smem_bytes(P, W, R, C, Bc, Gn)
        limit = lib.ga_gen_step_max_smem_bytes(dev.index)
        if smem > limit:
            raise ValueError(f"ga_gen_step: P={P}, W={W} needs {smem} bytes of "
                             f"shared memory per block; this card allows {limit}")
        f32 = [x.to(torch.float32).contiguous() for x in (pop, scores, u)]
        tabs = [leaf.to(torch.float32).contiguous() for leaf in tables]
        kind32 = kind.to(device=dev, dtype=torch.int32).contiguous()
        area32 = area.to(device=dev, dtype=torch.float32).contiguous()
        grids, sizes, vt = _grid_args(tech, dev)
        new_pop = torch.empty((B, P, n), dtype=torch.float32, device=dev)
        children = torch.empty_like(new_pop)
        new_scores = torch.empty((B, P), dtype=torch.float32, device=dev)
        child_scores = torch.empty_like(new_scores)
        consts = _consts(tech, sbx_prob, n)
        ptrs = [t.data_ptr() for t in (
            *f32, *tabs, grids, sizes, vt, kind32, area32,
            new_pop, new_scores, children, child_scores)]
        rc = lib.ga_gen_step_launch(
            *ptrs, B, P, W, grids.shape[1], R, C, Bc, Gn, int(gs[7]),
            consts, len(consts), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(_NAME, rc)
    ga_gen_step.launches += 1
    return new_pop, new_scores, children, child_scores


ga_gen_step.launches = 0
