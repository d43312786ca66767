"""The paper's hardware search space (~1.9e7 configurations).

Nine discrete parameters (paper Fig. 1 / Sec. III-B).  The genome is a
continuous relaxation: 9 genes in [0, 1), decoded per gene to a grid index
(as pymoo treats integer grids under SBX/polynomial mutation).

Grid sizes multiply to 5*5*5*4*6 * 20 * 4 * 8 * 10 = 19,200,000 ~ 1.9e7,
the paper's stated search-space size.

``configure_grid(density)`` refines every axis except ``bits_cell`` by
inserting ``density - 1`` interpolated points per interval (geometric for
the hardware counts and timing/buffer axes, linear for ``v_op``), keeping
every original grid point.  Every content cache keyed by a workload
fingerprint also keys on ``grid_token()``, which equals the JAX package's
token for the same grid.  The default density is 1 (the paper's grid),
overridable with ``REPRO_GRID_DENSITY`` at import.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.imc.design import DesignArrays

# name -> grid of values (ordered); the paper's density-1 grid
_BASE_SPACE: Dict[str, np.ndarray] = {
    "rows": np.array([32, 64, 128, 256, 512], np.float32),
    "cols": np.array([32, 64, 128, 256, 512], np.float32),
    "c_per_tile": np.array([2, 4, 8, 16, 32], np.float32),
    "t_per_router": np.array([2, 4, 8, 16], np.float32),
    "g_per_chip": np.array([2, 4, 8, 16, 32, 64], np.float32),
    "v_op": np.round(np.arange(0.70, 1.20, 0.025), 3).astype(np.float32),  # 20
    "bits_cell": np.array([1, 2, 3, 4], np.float32),
    "t_cycle_ns": np.array([0.5, 0.75, 1.0, 1.5, 2.0, 3.0, 4.0, 8.0], np.float32),
    "glb_mb": np.array(
        [0.125, 0.25, 0.5, 0.75, 1.0, 2.0, 3.0, 4.0, 8.0, 16.0], np.float32
    ),
}

# how each axis refines: geometric midpoints rounded to integers for the
# hardware counts, geometric for timings/buffers, linear for voltage;
# bits_cell stays exact (fractional cell bits are not physical)
_REFINE_KIND: Dict[str, str] = {
    "rows": "geom_int",
    "cols": "geom_int",
    "c_per_tile": "geom_int",
    "t_per_router": "geom_int",
    "g_per_chip": "geom_int",
    "v_op": "linear",
    "bits_cell": "exact",
    "t_cycle_ns": "geom",
    "glb_mb": "geom",
}

FIELDS: Tuple[str, ...] = tuple(DesignArrays._fields)
assert set(_BASE_SPACE) == set(FIELDS), (set(_BASE_SPACE), set(FIELDS))
N_GENES = len(FIELDS)


def _refine_axis(vals: np.ndarray, density: int, kind: str) -> np.ndarray:
    if density <= 1 or kind == "exact":
        return vals.copy()
    out = []
    for a, b in zip(vals[:-1], vals[1:]):
        out.append(float(a))
        for j in range(1, density):
            t = j / density
            if kind == "linear":
                m = round(a + (b - a) * t, 4)
            else:
                m = a * (b / a) ** t
                if kind == "geom_int":
                    m = round(m)
            out.append(float(m))
    out.append(float(vals[-1]))
    # sorted unique: integer rounding of close midpoints may collide
    return np.unique(np.array(out, np.float32))


def _build_space(density: int) -> Dict[str, np.ndarray]:
    return {
        f: _refine_axis(_BASE_SPACE[f], density, _REFINE_KIND[f])
        for f in FIELDS
    }


def _compute_token(sp: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for f in FIELDS:
        h.update(np.asarray(sp[f], np.float32).tobytes())
    return h.hexdigest()[:16]


GRID_DENSITY = max(1, int(os.environ.get("REPRO_GRID_DENSITY", "1")))
SPACE: Dict[str, np.ndarray] = _build_space(GRID_DENSITY)
GRID_SIZES = np.array([len(SPACE[f]) for f in FIELDS], np.int32)
SPACE_SIZE = int(np.prod(GRID_SIZES.astype(np.int64)))
_GRID_TOKEN = _compute_token(SPACE)
# (grid token, device) -> (grids_pad (n, Gmax) f32, sizes (n,) i64)
_DEVICE_GRIDS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def grid_token() -> str:
    """Content hash of the active grid: every cache keyed by workload
    fingerprint also keys on this, so reconfiguring the grid can never
    serve a stale table or result."""
    return _GRID_TOKEN


def configure_grid(density: int = 1) -> None:
    """Rebuild the search space at the given refinement density.  Device
    copies of the grids are keyed by ``grid_token()``, so nothing cached
    for the old grid is ever served for the new one."""
    global GRID_DENSITY, SPACE, GRID_SIZES, SPACE_SIZE, _GRID_TOKEN
    density = max(1, int(density))
    if density == GRID_DENSITY:
        return
    GRID_DENSITY = density
    SPACE = _build_space(density)
    GRID_SIZES = np.array([len(SPACE[f]) for f in FIELDS], np.int32)
    SPACE_SIZE = int(np.prod(GRID_SIZES.astype(np.int64)))
    _GRID_TOKEN = _compute_token(SPACE)


def padded_grids(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The active grid on ``device``: values ``(n, Gmax)`` float32, each
    row zero-padded past its axis size, and the sizes ``(n,)`` int64."""
    device = torch.device(device)
    key = (_GRID_TOKEN, str(device))
    hit = _DEVICE_GRIDS.get(key)
    if hit is None:
        gmax = int(GRID_SIZES.max())
        pad = np.zeros((N_GENES, gmax), np.float32)
        for j, f in enumerate(FIELDS):
            pad[j, : len(SPACE[f])] = SPACE[f]
        hit = (torch.from_numpy(pad).to(device),
               torch.from_numpy(GRID_SIZES.astype(np.int64)).to(device))
        _DEVICE_GRIDS[key] = hit
    return hit


def decode(genomes: torch.Tensor) -> DesignArrays:
    """(..., P, 9) floats in [0,1) -> decoded design value arrays (..., P)."""
    return designs_from_indices(decode_indices(genomes))


def decode_indices(genomes: torch.Tensor) -> torch.Tensor:
    """(..., 9) genomes -> int64 grid indices (..., 9): ``trunc(g * n)``
    in float32, clamped to ``[0, n - 1]``."""
    grids, sizes = padded_grids(genomes.device)
    idx = (genomes.to(torch.float32) * sizes.to(torch.float32)).to(torch.int64)
    return torch.minimum(idx.clamp_min(0), sizes - 1)


def designs_from_indices(idx: torch.Tensor) -> DesignArrays:
    """(..., 9) integer grid indices -> decoded design value arrays."""
    grids, _ = padded_grids(idx.device)
    return DesignArrays(*(grids[j][idx[..., j]] for j in range(N_GENES)))


def decode_indices_np(genomes: np.ndarray) -> np.ndarray:
    """Host-side ``decode_indices`` (same float32 arithmetic, so identical
    indices) for result preparation; int32 like the JAX package's."""
    g = np.asarray(genomes, np.float32)
    sizes = GRID_SIZES.astype(np.float32)
    idx = (g * sizes).astype(np.int32)
    return np.clip(idx, 0, GRID_SIZES - 1)


def genome_from_indices(idx: np.ndarray) -> np.ndarray:
    """Integer indices (P, 9) -> genome centered in each grid cell."""
    return (np.asarray(idx, np.float64) + 0.5) / GRID_SIZES[None, :]


def design_dicts_from_indices(idx: np.ndarray) -> List[Dict[str, float]]:
    """Host-side: (P, 9) integer grid indices -> per-design name->value
    dicts (the single definition of the design-dict format)."""
    return [
        {f: float(SPACE[f][idx[i, j]]) for j, f in enumerate(FIELDS)}
        for i in range(len(idx))
    ]


def random_genomes(n: int, *, generator: Optional[torch.Generator] = None,
                   device="cpu", key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n, 9) uniform genomes in [0, 1) from ``generator``, or, given
    threefry keys (..., 2), the JAX package's ``random_genomes(key, n)``
    for each key: (..., n, 9) on the keys' device."""
    if key is not None:
        return prng.uniform(key, (n, N_GENES))
    return torch.rand((n, N_GENES), generator=generator, device=device,
                      dtype=torch.float32)
