"""The analytical IMC cost model, its decoding and its objective, plain.

Frozen from the paper's model as the search defines it (nine discrete
design parameters on a grid of 5*5*5*4*6*20*4*8*10 = 19,200,000 cells;
CIMLoop/NeuroSim-class closed-form energy, latency and area of 32 nm RRAM
crossbars; the worst case over a workload set, under an area limit).
Written from the model's equations, not from the program's code.

Two rules are part of the model's definition and stay in float32 whatever
the precision asked for (no lower than it): a gene decodes to the grid
index ``trunc(gene * n)`` in float32, clamped to ``[0, n - 1]``, and a
design is V/f-valid when ``t_cycle >= k * v / (v - v_th) ** alpha`` in
float32 (the cell v = 0.9 V, t = 1.0 ns lies on that boundary).
"""
from __future__ import annotations

import functools
import importlib.util
import math
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

# the paper's density-1 grid, in gene order
FIELDS = ("rows", "cols", "c_per_tile", "t_per_router", "g_per_chip", "v_op",
          "bits_cell", "t_cycle_ns", "glb_mb")
GRID: Dict[str, np.ndarray] = {
    "rows": np.array([32, 64, 128, 256, 512], np.float32),
    "cols": np.array([32, 64, 128, 256, 512], np.float32),
    "c_per_tile": np.array([2, 4, 8, 16, 32], np.float32),
    "t_per_router": np.array([2, 4, 8, 16], np.float32),
    "g_per_chip": np.array([2, 4, 8, 16, 32, 64], np.float32),
    "v_op": np.array([0.7, 0.725, 0.75, 0.775, 0.8, 0.825, 0.85, 0.875, 0.9, 0.925,
                      0.95, 0.975, 1.0, 1.025, 1.05, 1.075, 1.1, 1.125, 1.15, 1.175],
                     np.float32),
    "bits_cell": np.array([1, 2, 3, 4], np.float32),
    "t_cycle_ns": np.array([0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 4.0, 8.0], np.float32),
    "glb_mb": np.array([0.125, 0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 4.0, 8.0, 16.0],
                       np.float32),
}
SIZES = np.array([len(GRID[f]) for f in FIELDS], np.int64)
N_CELLS = int(np.prod(SIZES))

# technology constants (32 nm CMOS, HfO2 1T1R RRAM, ISAAC-style tiles)
WEIGHT_BITS = 8
INPUT_BITS = 8
ADC_ENERGY_PJ = 2.0
ADC_AREA_MM2 = 3.0e-3
ADC_SHARE = 32
DAC_ENERGY_PJ = 0.05
DRIVER_AREA_MM2_PER_ROW = 2.0e-6
ROUTER_ENERGY_PJ_PER_BYTE = 1.6
ROUTER_AREA_MM2 = 0.05
ROUTER_FLIT_BYTES = 4.0
TILE_BUF_ENERGY_PJ_PER_BYTE = 1.0
GLB_ENERGY_PJ_PER_BYTE = 3.0
SRAM_AREA_MM2_PER_MB = 1.4
TILE_BUF_KB = 8.0
DRAM_ENERGY_PJ_PER_BYTE = 32.0
DRAM_BW_BYTES_PER_NS = 25.6
LEAK_MW_PER_MM2 = 5.0
V_NOMINAL, V_TH, ALPHA = 0.9, 0.35, 1.3
G_AVG_S = 0.5 * (1.0 / 6.0e3 + 1.0 / 1.0e5)  # mean of LRS and HRS conductance
CELL_AREA_MM2 = 12.0 * (32.0e-9 ** 2) * 1e6  # 12 F^2 at 32 nm
AREA_OVERHEAD = 1.10  # global wiring and pads

OBJECTIVES = Path(__file__).resolve().parent / "objectives"
KINDS = tuple(sorted(p.stem for p in OBJECTIVES.glob("*.py")))


@functools.lru_cache(maxsize=None)
def objective(kind: str):
    """The objective named ``kind``: ``objectives/<kind>.py``, whose
    ``score(energy, latency, area)`` maps the worst-case energy and latency
    over a workload set and the area to a score (lower is better).  Its
    ``ORDERED`` (default True) says that an answer lists its designs best
    first."""
    path = OBJECTIVES / f"{kind}.py"
    if not path.is_file():
        raise KeyError(f"no objective {kind!r} in {OBJECTIVES}")
    spec = importlib.util.spec_from_file_location(f"bench_objective_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vf_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if torch.finfo(dtype).bits >= 32 else dtype


def decode(genomes: torch.Tensor) -> torch.Tensor:
    """(N, 9) genes in [0, 1) -> (N, 9) int64 grid indices."""
    sizes = torch.as_tensor(SIZES, device=genomes.device)
    idx = (genomes.to(torch.float32) * sizes.to(torch.float32)).to(torch.int64)
    return torch.minimum(idx.clamp_min(0), sizes - 1)


def values(idx: torch.Tensor) -> Dict[str, torch.Tensor]:
    """(..., 9) grid indices -> {field: float32 values (...)}."""
    return {f: torch.as_tensor(GRID[f], device=idx.device)[idx[..., j]]
            for j, f in enumerate(FIELDS)}


def vf_table(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(20, 8) V/f validity over the (v_op, t_cycle_ns) grid, computed on
    the CPU (another device's ``pow`` may round the boundary cell the other
    way)."""
    dt = _vf_dtype(dtype)
    v = torch.as_tensor(GRID["v_op"]).to(dt)[:, None]
    t = torch.as_tensor(GRID["t_cycle_ns"]).to(dt)[None, :]
    k = (V_NOMINAL - V_TH) ** ALPHA / V_NOMINAL
    return (t >= k * v / (v - V_TH) ** ALPHA).to(device)


def area(d: Dict[str, torch.Tensor], dtype=torch.float64) -> torch.Tensor:
    g = d["g_per_chip"].to(dtype)
    n_tiles = g * d["t_per_router"].to(dtype)
    rows, cols = d["rows"].to(dtype), d["cols"].to(dtype)
    xbar = (rows * cols * CELL_AREA_MM2 + rows * DRIVER_AREA_MM2_PER_ROW
            + cols / ADC_SHARE * ADC_AREA_MM2)
    a = (n_tiles * d["c_per_tile"].to(dtype) * xbar
         + n_tiles * (TILE_BUF_KB / 1024.0 * SRAM_AREA_MM2_PER_MB)
         + g * ROUTER_AREA_MM2 + d["glb_mb"].to(dtype) * SRAM_AREA_MM2_PER_MB)
    return a * AREA_OVERHEAD


def evaluate(idx: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
             dtype=torch.float64):
    """Designs at grid indices (N, 9) on workloads feats (W, L, 6) = (M, K, N, A_in,
    A_out, groups) per layer, mask (W, L) -> energy pJ (N, W), latency ns
    (N, W), area mm^2 (N,), fits (N, W), valid (N,), all in ``dtype``."""
    d = values(idx)
    M, K, Nc, A_in, A_out, G = (x[None] for x in feats.to(dtype).unbind(-1))
    mk = mask.to(dtype)[None]

    def col(f):  # (N,) -> (N, 1, 1) against layers (1, W, L)
        return d[f].to(dtype)[:, None, None]

    rows, cols, v, t = col("rows"), col("cols"), col("v_op"), col("t_cycle_ns")
    g = col("g_per_chip")
    cpw = torch.ceil(WEIGHT_BITS / col("bits_cell"))
    col_splits = torch.ceil(Nc * cpw / cols)
    demand = (torch.ceil(K / rows) * col_splits * G * mk).sum(-1)
    capacity = (d["g_per_chip"].to(dtype) * d["t_per_router"].to(dtype)
                * d["c_per_tile"].to(dtype))
    fits = demand <= capacity[:, None]

    moved = A_in + A_out  # 8-bit activations, one byte each
    spill = torch.clamp_min(moved - col("glb_mb") * float(1 << 20), 0.0)
    latency = ((M * (INPUT_BITS * ADC_SHARE) * t * mk).sum(-1)
               + (moved / (g * ROUTER_FLIT_BYTES) * t * mk).sum(-1)
               + (spill * mk).sum(-1) / DRAM_BW_BYTES_PER_NS)

    vectors = M * INPUT_BITS * G * mk  # bit-serial input presentations
    a = area(d, dtype)
    energy = ((vectors * K * Nc * cpw * (v * v * G_AVG_S * t * 1e3)).sum(-1)
              + (vectors * Nc * cpw * ADC_ENERGY_PJ).sum(-1)
              + (vectors * K * col_splits * DAC_ENERGY_PJ).sum(-1)
              + (moved * (ROUTER_ENERGY_PJ_PER_BYTE + TILE_BUF_ENERGY_PJ_PER_BYTE
                          + GLB_ENERGY_PJ_PER_BYTE) * mk).sum(-1)
              + (spill * DRAM_ENERGY_PJ_PER_BYTE * mk).sum(-1)
              + LEAK_MW_PER_MM2 * a[:, None] * latency)  # 1 mW x 1 ns = 1 pJ
    valid = vf_table(dtype, idx.device)[idx[:, FIELDS.index("v_op")],
                                        idx[:, FIELDS.index("t_cycle_ns")]]
    return energy, latency, a, fits, valid


def score(kind: str, area_limit: float, energy, latency, a, fits, valid) -> torch.Tensor:
    """The objective of each design (lower is better): the worst case over
    the workloads; +inf where it does not fit, is not V/f-valid or exceeds
    the area limit."""
    s = objective(kind).score(energy.amax(-1), latency.amax(-1), a)
    ok = fits.all(-1) & valid & (a <= area_limit)
    return torch.where(ok, s, torch.full_like(s, math.inf))


def score_genomes(genomes: torch.Tensor, feats: torch.Tensor, mask: torch.Tensor,
                  kind: str, area_limit: float, dtype=torch.float64,
                  block: int = 65536) -> torch.Tensor:
    """Scores (N,) of genomes (N, 9) on one workload set, in blocks of
    designs so that (block, W, L) fits."""
    out = []
    for i in range(0, genomes.shape[0], block):
        idx = decode(genomes[i:i + block])
        out.append(score(kind, area_limit, *evaluate(idx, feats, mask, dtype)))
    if not out:
        return torch.zeros((0,), dtype=dtype, device=genomes.device)
    return torch.cat(out)


def workload_tensors(layers: Sequence[Sequence[Sequence[int]]], device="cpu"):
    """Layer tables [[(M, K, N, A_in, A_out, G), ...], ...] -> feats (W, L, 6)
    float64 and mask (W, L), zero-padded to the deepest."""
    L = max(len(t) for t in layers)
    feats = torch.zeros((len(layers), L, 6), dtype=torch.float64)
    mask = torch.zeros((len(layers), L), dtype=torch.bool)
    for w, t in enumerate(layers):
        feats[w, :len(t)] = torch.as_tensor(np.asarray(t, np.float64))
        mask[w, :len(t)] = True
    return feats.to(device), mask.to(device)
