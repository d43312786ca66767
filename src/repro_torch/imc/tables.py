"""Factorized IMC cost model: per-workload grid tables -> O(W) gathers.

The layer axis is reduced ONCE per workload into sufficient statistics
over the discrete grid (``core.space``):

  demand[w, r, c, b] = sum_l ceil(K/rows_r) * ceil(N*cpw_b/cols_c) * G     (R, C, Bc)
  dac[w, c, b]       = sum_l M * K * ceil(N*cpw_b/cols_c) * G              (C, Bc)
  spill[w, g]        = sum_l max(bytes_l - glb_g, 0)                       (Gn,)
  sum_m, sum_bytes, sum_mkng, sum_mng                                      scalars

(each masked by the layer mask), after which scoring a design is O(W)
table lookups at its ``space.decode_indices`` grid indices plus ~20
scalar flops, independent of workload depth L.  Term structure and
association order follow the JAX package's ``imc/tables.py`` line for
line; the dense ``imc.cost`` path stays the oracle.  Every leaf may carry
leading batch axes ``(..., W, ...)``: one table slice per search.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import space
from repro_torch.imc.cost import (
    EvalResult,
    _rdiv,
    _true_div,
    area_mm2,
    vt_valid_from_indices,
)
from repro_torch.imc.tech import TECH, TechParams

# grid-index columns of a decoded (..., 9) index matrix (space.FIELDS order)
I_ROWS = space.FIELDS.index("rows")
I_COLS = space.FIELDS.index("cols")
I_BITS = space.FIELDS.index("bits_cell")
I_GLB = space.FIELDS.index("glb_mb")
I_VOP = space.FIELDS.index("v_op")
I_TCYC = space.FIELDS.index("t_cycle_ns")


class WorkloadTables(NamedTuple):
    """Per-workload sufficient statistics; every field has leading dim W
    (or (B, W) when built batched)."""

    demand: torch.Tensor  # (W, R, C, Bc) crossbar demand per (rows, cols, bits)
    dac: torch.Tensor  # (W, C, Bc)  sum M*K*ceil(N*cpw/cols)*G
    spill: torch.Tensor  # (W, Gn)   sum max(bytes_l - glb, 0)
    sum_m: torch.Tensor  # (W,)      sum M
    sum_bytes: torch.Tensor  # (W,)  sum (A_in + A_out)
    sum_mkng: torch.Tensor  # (W,)   sum M*K*N*G
    sum_mng: torch.Tensor  # (W,)    sum M*N*G


def build_tables_arrays(
    feats: torch.Tensor, mask: torch.Tensor, tech: TechParams = TECH
) -> WorkloadTables:
    """feats (..., W, L, 6), mask (..., W, L) -> tables on feats' device."""
    dev = feats.device
    M, K, N, A_in, A_out, G = feats.to(torch.float32).unbind(-1)
    mk = mask.to(torch.float32)

    def grid(f):
        return torch.as_tensor(space.SPACE[f], dtype=torch.float32, device=dev)

    rows_g, cols_g, bits_g = grid("rows"), grid("cols"), grid("bits_cell")
    glb_g = grid("glb_mb") * float(1 << 20)  # (Gn,) bytes

    cpw = torch.ceil(_rdiv(float(tech.weight_bits), bits_g))  # (Bc,)
    row_splits = torch.ceil(K[..., None] / rows_g)  # (..., W, L, R)
    col_splits = torch.ceil(
        N[..., None, None] * cpw / cols_g[:, None])  # (..., W, L, C, Bc)

    gm = G * mk  # (..., W, L)
    demand = (
        row_splits[..., :, None, None] * col_splits[..., None, :, :]
        * gm[..., None, None, None]
    ).sum(-4)  # (..., W, R, C, Bc)
    dac = ((M * K * gm)[..., None, None] * col_splits).sum(-3)  # (..., W, C, Bc)

    bytes_l = A_in + A_out
    spill = (torch.clamp_min(bytes_l[..., None] - glb_g, 0.0)
             * mk[..., None]).sum(-2)

    return WorkloadTables(
        demand=demand,
        dac=dac,
        spill=spill,
        sum_m=(M * mk).sum(-1),
        sum_bytes=(bytes_l * mk).sum(-1),
        sum_mkng=(M * K * N * G * mk).sum(-1),
        sum_mng=(M * N * G * mk).sum(-1),
    )


def build_tables_batched(
    feats: torch.Tensor, mask: torch.Tensor, tech: TechParams = TECH
) -> WorkloadTables:
    """Batched workload sets: feats (B, W, L, 6), mask (B, W, L) -> tables
    with a leading B axis on every leaf (one slice per batched search)."""
    if feats.dim() != 4:
        raise ValueError(f"feats must be (B, W, L, 6), got {tuple(feats.shape)}")
    return build_tables_arrays(feats, mask, tech)


def table_bytes(tables: WorkloadTables) -> int:
    """Total table footprint in bytes (all leaves, any batch shape).  Every
    leaf scales with the grid's density (``demand`` is (W, R, C, Bc), so
    ``space.configure_grid(d)`` multiplies it by ~d^3): the memory to weigh
    against the per-generation lookups when picking a density."""
    return int(sum(leaf.numel() * leaf.element_size() for leaf in tables))


def grid_table_shape() -> dict:
    """Per-axis sizes of the active grid that the table leaves index over
    (R, C, Bc, Gn)."""
    return {f: len(space.SPACE[f]) for f in ("rows", "cols", "bits_cell", "glb_mb")}


def lookup_tables(idx: torch.Tensor, tables: WorkloadTables):
    """Gather ``(demand, dac, spill)`` at designs' grid indices.
    idx (..., P, 9) against tables (..., W, ...) -> three (..., P, W)."""
    ri, ci = idx[..., I_ROWS], idx[..., I_COLS]
    bi, gi = idx[..., I_BITS], idx[..., I_GLB]
    R, C, Bc = tables.demand.shape[-3:]
    W = tables.demand.shape[-4]

    def take(table2, flat):  # table2 (..., W, T), flat (..., P) -> (..., P, W)
        f = flat.unsqueeze(-2).expand(*flat.shape[:-1], W, flat.shape[-1])
        return torch.gather(table2, -1, f).transpose(-1, -2)

    demand = take(tables.demand.flatten(-3), (ri * C + ci) * Bc + bi)
    dac_t = take(tables.dac.flatten(-2), ci * Bc + bi)
    spill = take(tables.spill, gi)
    return demand, dac_t, spill


def evaluate_designs_tables(
    idx: torch.Tensor, tables: WorkloadTables, tech: TechParams = TECH
) -> EvalResult:
    """Score designs given as (..., P, 9) integer grid indices against
    precomputed tables (..., W, ...): 3 lookups + scalar algebra per
    (design, workload), no layer axis anywhere."""
    d = space.designs_from_indices(idx)
    demand, dac_t, spill = lookup_tables(idx, tables)

    capacity = (d.g_per_chip * d.t_per_router * d.c_per_tile).to(torch.float32)
    fits = demand <= capacity[..., None]
    util = demand / capacity[..., None]

    # design-side coefficients (..., P, 1) against workload scalars (..., 1, W)
    def ws(x):
        return x[..., None, :]

    t_cyc = d.t_cycle_ns[..., None]
    phases = float(tech.input_bits)
    cpw = torch.ceil(_rdiv(float(tech.weight_bits), d.bits_cell))[..., None]

    # ---------------- latency ------------------------------------------------
    l_comp = ws(tables.sum_m) * (phases * tech.adc_share) * t_cyc
    l_comm = (
        ws(tables.sum_bytes)
        / (d.g_per_chip[..., None] * tech.router_flit_bytes)
        * t_cyc
    )
    l_dram = _true_div(spill, tech.dram_bw_bytes_per_ns)
    latency = l_comp + l_comm + l_dram  # (..., P, W)

    # ---------------- energy -------------------------------------------------
    e_cell = (d.v_op * d.v_op * tech.g_avg_s * d.t_cycle_ns * 1e3)[..., None]
    e_analog = ws(tables.sum_mkng) * phases * cpw * e_cell
    e_adc = ws(tables.sum_mng) * phases * cpw * tech.adc_energy_pj
    e_dac = dac_t * phases * tech.dac_energy_pj
    e_route = ws(tables.sum_bytes) * tech.router_energy_pj_per_byte
    e_buf = ws(tables.sum_bytes) * (
        tech.tile_buf_energy_pj_per_byte + tech.glb_energy_pj_per_byte
    )
    e_dram = spill * tech.dram_energy_pj_per_byte

    area = area_mm2(d, tech)  # (..., P)
    e_leak = tech.leak_mw_per_mm2 * area[..., None] * latency
    energy = e_analog + e_adc + e_dac + e_route + e_buf + e_dram + e_leak

    return EvalResult(
        energy_pj=energy,
        latency_ns=latency,
        area_mm2=area,
        fits=fits,
        valid=vt_valid_from_indices(idx[..., I_VOP], idx[..., I_TCYC], tech),
        util=util,
    )


def evaluate_genomes_tables(
    genomes: torch.Tensor, tables: WorkloadTables, tech: TechParams = TECH
) -> EvalResult:
    """(..., P, 9) genomes in [0, 1) -> table-path EvalResult."""
    return evaluate_designs_tables(space.decode_indices(genomes), tables, tech)
