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
import functools
from typing import Dict, Tuple

import torch

from repro_torch.core import space
from repro_torch.core.ga import GENE_MAX, MUT_ETA, SBX_ETA, SBX_PROB, block_layout
from repro_torch.imc.cost import valid_vt_mask
from repro_torch.imc.tables import WorkloadTables
from repro_torch.imc.tech import TECH, TechParams
from repro_torch.kernels import _build, _launch
from repro_torch.kernels.ga_gen_step.ref import ga_gen_step_ref

_NAME = "ga_gen_step"
# (tech, sbx_prob, n_genes) -> constants; keyed by the whole TechParams value
_CONSTS: Dict[tuple, ctypes.Array] = {}
_GRID_ARGS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
# (P, W, device index, grid dims) whose shared memory fits the card
_SMEM_OK: set = set()
_LIB = None


def build_consts(tech: TechParams, sbx_prob: float, n_genes: int) -> ctypes.Array:
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


def consts(tech: TechParams, sbx_prob: float, n_genes: int) -> ctypes.Array:
    """``build_consts(...)``, built once per distinct argument triple."""
    key = (tech, sbx_prob, n_genes)
    hit = _CONSTS.get(key)
    if hit is None:
        hit = _CONSTS[key] = build_consts(tech, sbx_prob, n_genes)
    return hit


@functools.lru_cache(maxsize=None)
def _tot(P: int, n: int) -> int:
    return block_layout(P, n).tot


def _grid_args(tech: TechParams, index: int):
    """(grids (9, Gmax) f32, sizes (9,) i32, V/f mask (V, Tc) u8) on CUDA
    device ``index``."""
    key = (tech, space.grid_token(), index)
    hit = _GRID_ARGS.get(key)
    if hit is None:
        dev = torch.device("cuda", index)
        grids, sizes = space.padded_grids(dev)
        hit = (grids.contiguous(), sizes.to(torch.int32).contiguous(),
               valid_vt_mask(tech).to(torch.uint8).to(dev).contiguous())
        _GRID_ARGS[key] = hit
    return hit


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load(_NAME)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ga_gen_step_launch.argtypes = (
            [p] * 19 + [i] * 10 + [ctypes.POINTER(ctypes.c_float), i, i, p])
        lib.ga_gen_step_launch.restype = i
        lib.ga_gen_step_smem_bytes.argtypes = [i] * 9
        lib.ga_gen_step_smem_bytes.restype = ctypes.c_longlong
        lib.ga_gen_step_max_smem_bytes.argtypes = [i]
        lib.ga_gen_step_max_smem_bytes.restype = i
        lib.ga_gen_step_rank_max.argtypes = []
        lib.ga_gen_step_rank_max.restype = i
        _LIB = lib
    return _LIB


def _check_smem(P: int, W: int, index: int, dims: tuple) -> None:
    """Raise if one block of (P, W) does not fit this card's shared memory."""
    key = (P, W, index, dims)
    if key in _SMEM_OK:
        return
    lib = _lib()
    smem = lib.ga_gen_step_smem_bytes(P, W, *dims)
    limit = lib.ga_gen_step_max_smem_bytes(index)
    if smem > limit:
        raise ValueError(f"ga_gen_step: P={P}, W={W} needs {smem} bytes of "
                         f"shared memory per block; this card allows {limit}")
    _SMEM_OK.add(key)


def survival_path(P: int) -> str:
    """Which survival the kernel runs at population P: "rank" (by counting)
    or "bitonic" (the sorting network)."""
    return "rank" if 2 * P <= _lib().ga_gen_step_rank_max() else "bitonic"


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
    tot = _tot(P, n)
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
    index = _launch.cuda_index(dev)
    grids, sizes, vt = _grid_args(tech, index)
    dims = (grids.shape[1], R, C, Bc, Gn, vt.shape[0], vt.shape[1])
    _check_smem(P, W, index, dims)
    f32 = [_launch.contiguous(x, torch.float32) for x in (pop, scores, u)]
    tabs = [_launch.contiguous(leaf, torch.float32) for leaf in tables]
    kind64 = _launch.contiguous(kind.to(dev), torch.int64)
    area32 = _launch.contiguous(area.to(dev), torch.float32)
    # the four outputs in one buffer: new_pop, children, new_scores, child_scores
    n_pop, n_sc = B * P * n, B * P
    out = torch.empty(2 * (n_pop + n_sc), dtype=torch.float32, device=dev)
    o = out.data_ptr()
    c = consts(tech, sbx_prob, n)
    # the launcher selects the device itself, in its own runtime
    rc = _lib().ga_gen_step_launch(
        *[t.data_ptr() for t in (*f32, *tabs, grids, sizes, vt, kind64, area32)],
        o, o + 4 * 2 * n_pop, o + 4 * n_pop, o + 4 * (2 * n_pop + n_sc),
        B, P, W, *dims, c, len(c), index, _launch.stream(index))
    _build.check(_NAME, rc)
    ga_gen_step.launches += 1
    new_pop, children, new_scores, child_scores = out.split((n_pop, n_pop, n_sc, n_sc))
    return (new_pop.view(B, P, n), new_scores.view(B, P),
            children.view(B, P, n), child_scores.view(B, P))


ga_gen_step.launches = 0
