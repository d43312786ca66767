"""The ga_gen_step kernel's wrapper: one whole GA generation on the
factorized tables with the indexed objective, for B searches at once.

``ga_gen_step(pop, scores, u, ctx)`` with ``ctx = (tables, kind, area)``
returns ``(new_pop, new_scores, children, child_scores)``:

* on CPU tensors it runs the plain version (``ref.ga_gen_step_ref``);
* on CUDA tensors it calls the operator ``repro_torch::ga_gen_step``
  (``GA_GEN_STEP``), whose CUDA implementation
  (``csrc/ga_gen_step_op.cpp``) checks that one block fits the card's
  shared memory and launches ``csrc/ga_gen_step.cu`` once (one block per
  search), or raises.  There is no fallback.  Its fake implementation
  gives the four outputs' shapes under ``FakeTensorMode`` and raises the
  wrapper's shape errors (``check``), which the CUDA implementation
  raises word for word.

``ga_gen_step.launches`` counts kernel launches (never a fake call).  The
engine attaches this function as the ``gen_step`` of its table-backend
callback, so on the card every generation of ``backend="table"`` runs
through the kernel.
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
_CONSTS: Dict[tuple, Tuple[float, ...]] = {}
_GRID_ARGS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}
_LIB = None


def build_consts(tech: TechParams, sbx_prob: float, n_genes: int) -> Tuple[float, ...]:
    """float32 constants in the kernel's ``Const`` order, each the value
    PyTorch uses for the same Python scalar in the plain version."""
    return _launch.float32_values([
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


def consts(tech: TechParams, sbx_prob: float, n_genes: int) -> Tuple[float, ...]:
    """``build_consts(...)``, built once per distinct argument triple."""
    key = (tech, sbx_prob, n_genes)
    hit = _CONSTS.get(key)
    if hit is None:
        hit = _CONSTS[key] = build_consts(tech, sbx_prob, n_genes)
    return hit


@functools.lru_cache(maxsize=None)
def _tot(P: int, n: int) -> int:
    return block_layout(P, n).tot


def _grid_args(tech: TechParams, dev: torch.device):
    """(grids (9, Gmax) f32, sizes (9,) i32, V/f mask (V, Tc) u8) of the
    active grid on CUDA device ``dev``."""
    key = (tech, space.grid_token(), dev)
    hit = _GRID_ARGS.get(key)
    if hit is None:
        grids, sizes = space.padded_grids(dev)
        hit = (grids.contiguous(), sizes.to(torch.int32).contiguous(),
               valid_vt_mask(tech).to(torch.uint8).to(dev).contiguous())
        _GRID_ARGS[key] = hit
    return hit


def check(pop: torch.Tensor, scores: torch.Tensor, u: torch.Tensor,
          tables: WorkloadTables) -> None:
    """The wrapper's shape and device errors (the operator's too)."""
    if pop.dim() != 3 or pop.shape[2] != space.N_GENES:
        raise ValueError(f"pop must be (B, P, {space.N_GENES}), got {tuple(pop.shape)}")
    B, P, n = pop.shape
    tot = _tot(int(P), int(n))
    if tuple(scores.shape) != (B, P) or tuple(u.shape) != (B, tot):
        raise ValueError(f"scores {tuple(scores.shape)} / u {tuple(u.shape)} do "
                         f"not match (B, P) = {(B, P)}, tot = {tot}")
    for name, t in (("scores", scores), ("u", u)):
        if t.device != pop.device:
            raise ValueError(f"{name} on {t.device}, pop on {pop.device}")
    W = tables.demand.shape[1]
    for name, leaf in zip(WorkloadTables._fields, tables):
        if leaf.shape[:2] != (B, W) or leaf.device != pop.device:
            raise ValueError(f"table {name}: {tuple(leaf.shape)} on {leaf.device}, "
                             f"expected leading {(B, W)} on {pop.device}")


def _active_grid(tables: WorkloadTables) -> None:
    """Raise unless the tables were built on the active grid (the one whose
    grids the wrapper passes)."""
    gs = space.GRID_SIZES
    dims = (*tables.demand.shape[2:], *tables.spill.shape[2:])
    if dims != (int(gs[0]), int(gs[1]), int(gs[6]), int(gs[8])):
        raise ValueError("tables were built for another grid than the active one")


def _fake(pop, scores, u, demand, dac, spill, sum_m, sum_bytes, sum_mkng, sum_mng, kind,
          area, grids, sizes, vt_mask, consts):
    check(pop, scores, u, WorkloadTables(demand, dac, spill, sum_m, sum_bytes, sum_mkng,
                                         sum_mng))
    B, P, n = pop.shape
    return (pop.new_empty((B, P, n), dtype=torch.float32),
            pop.new_empty((B, P), dtype=torch.float32),
            pop.new_empty((B, P, n), dtype=torch.float32),
            pop.new_empty((B, P), dtype=torch.float32))


GA_GEN_STEP = _launch.define(
    "ga_gen_step(Tensor pop, Tensor scores, Tensor u, Tensor demand, Tensor dac, "
    "Tensor spill, Tensor sum_m, Tensor sum_bytes, Tensor sum_mkng, Tensor sum_mng, "
    "Tensor kind, Tensor area, Tensor grids, Tensor sizes, Tensor vt_mask, "
    "float[] consts) -> (Tensor, Tensor, Tensor, Tensor)", _fake)


def _lib():
    """The kernel library (its queries); loading it registers the
    operator's CUDA implementation."""
    global _LIB
    if _LIB is None:
        lib = _build.load(_NAME)
        lib.ga_gen_step_rank_max.argtypes = []
        lib.ga_gen_step_rank_max.restype = ctypes.c_int
        _LIB = lib
    return _LIB


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
    if tables.demand.dim() == 5 and tables.spill.dim() == 3:  # else the operator says
        _active_grid(tables)
    real = _launch.is_real(pop)
    if real:
        _lib()
    out = GA_GEN_STEP(pop, scores, u, *tables, kind, area, *_grid_args(tech, dev),
                      consts(tech, sbx_prob, space.N_GENES))
    if real:
        ga_gen_step.launches += 1
    return out


ga_gen_step.launches = 0
