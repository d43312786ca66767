"""The decoded-design record shared by the search space and the cost model
(re-exported by ``imc.cost``; a module of its own so that ``core.space``
and ``imc.cost`` can both import it without importing each other)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class DesignArrays(NamedTuple):
    """Decoded designs, each field (..., P) float32."""

    rows: torch.Tensor
    cols: torch.Tensor
    c_per_tile: torch.Tensor
    t_per_router: torch.Tensor
    g_per_chip: torch.Tensor
    v_op: torch.Tensor
    bits_cell: torch.Tensor
    t_cycle_ns: torch.Tensor
    glb_mb: torch.Tensor
