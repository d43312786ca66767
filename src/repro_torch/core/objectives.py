"""Objective functions f(E_w, L_w, A) s.t. A <= A_constr  (paper Eq. 1).

The *joint* part: metrics reduce with ``max`` over the workload axis: one
chip must serve the worst-case workload well.  Failed/invalid designs
score +inf (the GA can sample them; they never survive).

  ela   : max(E) * max(L) * A           (energy-latency-area, the headline)
  edp   : max(E) * max(L)               (energy-delay product)
  e     : max(E)
  l     : max(L)

all under the area constraint.  The Pareto and exponent-weighted
families of the JAX package are not ported yet.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from repro_torch.imc.cost import EvalResult

OBJECTIVES = ("ela", "edp", "e", "l")

# kind -> selector index for make_indexed_objective
OBJECTIVE_INDEX: Dict[str, int] = {k: i for i, k in enumerate(OBJECTIVES)}


def _joint(x: torch.Tensor) -> torch.Tensor:
    """(..., P, W) -> (..., P) worst case over the workload set."""
    return x.amax(dim=-1)


def make_objective(kind: str, area_constr_mm2: float = 150.0
                   ) -> Callable[[EvalResult], torch.Tensor]:
    """Score (lower is better), +inf when infeasible."""
    if kind not in OBJECTIVE_INDEX:
        raise ValueError(kind)

    def score(r: EvalResult) -> torch.Tensor:
        e = _joint(r.energy_pj)
        l = _joint(r.latency_ns)
        a = r.area_mm2
        s = {"ela": lambda: e * l * a, "edp": lambda: e * l,
             "e": lambda: e, "l": lambda: l}[kind]()
        feasible = r.fits.all(dim=-1) & r.valid & (a <= area_constr_mm2)
        return torch.where(feasible, s, math.inf)

    score.kind = kind
    score.area_constr = area_constr_mm2
    return score


def make_indexed_objective() -> Callable:
    """Objective selected per search by a kind index and an area
    constraint, both tensors with the searches' batch shape (``()`` for
    one search, ``(B,)`` for a batch).  Each branch computes exactly the
    expression of the matching ``make_objective`` kind, selected by a
    where-chain (the form the whole-generation kernel mirrors), so scores
    are bit-identical to the static path per element."""

    def score(r: EvalResult, kind_index: torch.Tensor,
              area_constr: torch.Tensor) -> torch.Tensor:
        e = _joint(r.energy_pj)
        l = _joint(r.latency_ns)
        a = r.area_mm2
        k = kind_index[..., None]
        s = torch.where(k == 0, e * l * a,
                        torch.where(k == 1, e * l, torch.where(k == 2, e, l)))
        feasible = (r.fits.all(dim=-1) & r.valid
                    & (a <= area_constr[..., None]))
        return torch.where(feasible, s, math.inf)

    return score
