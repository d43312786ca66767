"""Exact rank of a design among all 19,200,000 cells of the grid.

A search returns the best designs it found; how good they are is where
the design lies among every cell of the grid under the same workload set,
objective and area limit: its rank share, the share of the feasible cells
that score strictly better.  A search whose generations do nothing returns
the best of its seeded population, far down that order.

The layer sums factor over the grid's axes (the crossbar demand over rows,
cols and cell bits; the DAC energy over cols and cell bits; the DRAM spill
over the buffer size; the rest are plain sums), so each workload reduces to
a few small tables once, and every cell costs a handful of float64
operations.  The grid is walked in blocks of one (rows, cols) pair: 768,000
cells a block.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import model as m

F64 = torch.float64


def workload_tables(layers: Sequence[Sequence[int]], device) -> Dict[str, torch.Tensor]:
    """One workload's layer table [(M, K, N, A_in, A_out, G), ...] reduced
    over its layers for every grid value it meets."""
    x = torch.as_tensor(np.asarray(layers, np.float64), device=device)
    M, K, N, A_in, A_out, G = x.unbind(-1)  # (L,)
    g = {f: torch.as_tensor(m.GRID[f], device=device).to(F64) for f in m.FIELDS}
    cpw = torch.ceil(m.WEIGHT_BITS / g["bits_cell"])  # (Bc,)
    col_splits = torch.ceil(N[:, None, None] * cpw / g["cols"][:, None])  # (L, C, Bc)
    row_splits = torch.ceil(K[:, None] / g["rows"])  # (L, R)
    moved = A_in + A_out
    vectors = M * m.INPUT_BITS * G
    return {
        "demand": (row_splits[:, :, None, None] * col_splits[:, None]
                   * G[:, None, None, None]).sum(0),  # (R, C, Bc)
        "dac": ((vectors * K)[:, None, None] * col_splits).sum(0) * m.DAC_ENERGY_PJ,
        "spill": torch.clamp_min(moved[:, None] - g["glb_mb"] * float(1 << 20),
                                 0.0).sum(0),  # (Gn,)
        "analog": (vectors * K * N).sum(),
        "adc": (vectors * N).sum() * m.ADC_ENERGY_PJ,
        "m": M.sum(),
        "moved": moved.sum(),
    }


def _metrics(ix: Dict[str, torch.Tensor], tabs: Sequence[Dict[str, torch.Tensor]]):
    """Energy and latency per workload, area, fits per workload and
    validity of the cells at the (broadcastable) grid indices ``ix``."""
    dev = ix["rows"].device
    v = {f: torch.as_tensor(m.GRID[f], device=dev).to(F64)[ix[f]] for f in m.FIELDS}
    cpw = torch.ceil(m.WEIGHT_BITS / v["bits_cell"])
    a = m.area(v, F64)
    capacity = v["g_per_chip"] * v["t_per_router"] * v["c_per_tile"]
    valid = m.vf_table(F64, dev)[ix["v_op"], ix["t_cycle_ns"]]
    e_cell = v["v_op"] * v["v_op"] * m.G_AVG_S * v["t_cycle_ns"] * 1e3
    out = []
    for t in tabs:
        spill = t["spill"][ix["glb_mb"]]
        lat = (t["m"] * (m.INPUT_BITS * m.ADC_SHARE) * v["t_cycle_ns"]
               + t["moved"] / (v["g_per_chip"] * m.ROUTER_FLIT_BYTES) * v["t_cycle_ns"]
               + spill / m.DRAM_BW_BYTES_PER_NS)
        energy = (t["analog"] * cpw * e_cell + t["adc"] * cpw
                  + t["dac"][ix["cols"], ix["bits_cell"]]
                  + t["moved"] * (m.ROUTER_ENERGY_PJ_PER_BYTE + m.TILE_BUF_ENERGY_PJ_PER_BYTE
                                  + m.GLB_ENERGY_PJ_PER_BYTE)
                  + spill * m.DRAM_ENERGY_PJ_PER_BYTE + m.LEAK_MW_PER_MM2 * a * lat)
        fits = t["demand"][ix["rows"], ix["cols"], ix["bits_cell"]] <= capacity
        out.append((energy, lat, fits))
    return out, a, valid


def _score(kind: str, area_limit: float, per, a, valid) -> torch.Tensor:
    e = per[0][0]
    lat = per[0][1]
    ok = per[0][2] & valid & (a <= area_limit)
    for energy, l_w, fits in per[1:]:
        e, lat, ok = torch.maximum(e, energy), torch.maximum(lat, l_w), ok & fits
    s = m.objective(kind).score(e, lat, a)
    s, ok = torch.broadcast_tensors(s, ok)
    return torch.where(ok, s, torch.full_like(s, math.inf))


def _block_index(r: int, c: int, dev) -> Dict[str, torch.Tensor]:
    """Indices of the block of cells with rows index r and cols index c,
    broadcast over the other seven axes in grid order."""
    rest = m.FIELDS[2:]
    ix = {"rows": torch.tensor(r, device=dev), "cols": torch.tensor(c, device=dev)}
    for j, f in enumerate(rest):
        shape = [1] * len(rest)
        shape[j] = len(m.GRID[f])
        ix[f] = torch.arange(len(m.GRID[f]), device=dev).reshape(shape)
    return ix


Query = Tuple[Tuple[str, ...], str, float, np.ndarray]


def rank_shares(tables: Dict[str, Dict[str, torch.Tensor]], queries: Sequence[Query],
                device) -> List[float]:
    """For each query (workload names, objective kind, area limit, grid
    indices (9,) of a design, or None for no design): the share of the
    grid's feasible cells that score strictly better than it (all of them
    for no design; nan where no cell is feasible)."""
    groups: Dict[tuple, List[int]] = {}
    for i, (names, kind, area_limit, _) in enumerate(queries):
        groups.setdefault((tuple(names), kind, float(area_limit)), []).append(i)
    shares = [math.nan] * len(queries)
    for (names, kind, area_limit), rows in groups.items():
        tabs = [tables[n] for n in names]
        some = [queries[i][3] is not None for i in rows]
        idx = torch.as_tensor(np.stack([queries[i][3] if ok else np.zeros(len(m.FIELDS), np.int64)
                                        for i, ok in zip(rows, some)]), device=device)
        per, a, valid = _metrics({f: idx[:, j] for j, f in enumerate(m.FIELDS)}, tabs)
        thresholds = torch.where(torch.as_tensor(some, device=device),
                                 _score(kind, area_limit, per, a, valid), math.inf)
        better = torch.zeros(len(rows), dtype=torch.int64, device=device)
        feasible = 0
        for r in range(len(m.GRID["rows"])):
            for c in range(len(m.GRID["cols"])):
                per, a, valid = _metrics(_block_index(r, c, device), tabs)
                s = _score(kind, area_limit, per, a, valid).reshape(-1)
                s = torch.sort(s[torch.isfinite(s)]).values
                feasible += int(s.numel())
                better += torch.searchsorted(s, thresholds, right=False)
        for k, i in enumerate(rows):
            shares[i] = float(better[k]) / feasible if feasible else math.nan
    return shares
