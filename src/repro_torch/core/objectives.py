"""Objective functions f(E_w, L_w, A) s.t. A <= A_constr  (paper Eq. 1).

The *joint* part: metrics reduce with ``max`` over the workload axis: one
chip must serve the worst-case workload well.  Failed/invalid designs
score +inf (the GA can sample them; they never survive).

  ela   : max(E) * max(L) * A           (energy-latency-area, the headline)
  edp   : max(E) * max(L)               (energy-delay product)
  e     : max(E)
  l     : max(L)

all under the area constraint.  Two more families, as in the JAX
package: the exponent-weighted objective ``max(E)^wE * max(L)^wL * A^wA``
(``make_weighted_objective``; ``OBJECTIVE_WEIGHTS`` gives the weights of
each kind) and the Pareto objective (``make_pareto_objective``), whose
score is the (E, L, A) vector that NSGA-II survival (``core.ga``) ranks.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from repro_torch.imc.cost import EvalResult

# the score of an infeasible design
INF = math.inf

OBJECTIVES = ("ela", "edp", "e", "l")

# kind -> selector index for make_indexed_objective
OBJECTIVE_INDEX: Dict[str, int] = {k: i for i, k in enumerate(OBJECTIVES)}

# the Pareto-front family: not a scalar kind; requests select it with
# objective="pareto" and plan into their own signature group
PARETO = "pareto"
# component order of the Pareto objective vector: (max_W E, max_W L, A)
PARETO_AXES = ("e", "l", "a")
N_PARETO = len(PARETO_AXES)

# exponents (w_E, w_L, w_A) reproducing each kind as E^wE * L^wL * A^wA
OBJECTIVE_WEIGHTS: Dict[str, tuple] = {
    "ela": (1.0, 1.0, 1.0),
    "edp": (1.0, 1.0, 0.0),
    "e": (1.0, 0.0, 0.0),
    "l": (0.0, 1.0, 0.0),
}


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
        return torch.where(feasible, s, INF)

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
        return torch.where(feasible, s, INF)

    return score


def _feasible(r: EvalResult, a: torch.Tensor, area_constr) -> torch.Tensor:
    return r.fits.all(dim=-1) & r.valid & (a <= area_constr)


def make_pareto_objective() -> Callable:
    """Vector objective for Pareto-front search: per design the
    minimization triple ``(max_W E, max_W L, A)``, with the area constraint
    a tensor of the searches' batch shape.  An infeasible design gets +inf
    on every component: it dominates nothing, is dominated by every
    feasible design and ties with the other infeasible ones.  The scalar
    proxy ``e*l*a`` of a feasible row is the ``ela`` objective's bits."""

    def score(r: EvalResult, area_constr: torch.Tensor) -> torch.Tensor:
        e = _joint(r.energy_pj)
        l = _joint(r.latency_ns)
        a = r.area_mm2
        feasible = _feasible(r, a, area_constr[..., None])
        objs = torch.stack([e, l, a], dim=-1)  # (..., P, N_PARETO)
        return torch.where(feasible[..., None], objs, INF)

    return score


def pareto_scalar(objs: torch.Tensor) -> torch.Tensor:
    """Scalar E*L*A proxy of (..., N_PARETO) objective vectors: the ``ela``
    bits on feasible rows, +inf on infeasible ones.  Convergence curves, NaN
    guards and the ``top_scores`` of Pareto results read it."""
    return objs[..., 0] * objs[..., 1] * objs[..., 2]


def _pow(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x ** w`` with the exact cases exact on every device: an exponent
    of 1 gives ``x`` and 0 gives 1, as IEEE ``pow`` does; CUDA's ``powf``
    is only promised within 2 ulp, and the weights (1, 1, 1) must give
    the ``ela`` bits."""
    return torch.where(w == 1.0, x, torch.where(w == 0.0, torch.ones_like(x), x ** w))


def make_weighted_objective(area_constr_mm2: float = 150.0) -> Callable:
    """Exponent-weighted objective ``s = max(E)^wE * max(L)^wL * A^wA`` with
    per-search weights ``(..., 3)``, covering every kind in ``OBJECTIVES``
    (``OBJECTIVE_WEIGHTS``), so one batched GA can mix objective families.
    The area constraint is fixed per objective (it is part of the weighted
    family's signature)."""

    def score(r: EvalResult, weights: torch.Tensor) -> torch.Tensor:
        e = _joint(r.energy_pj)
        l = _joint(r.latency_ns)
        a = r.area_mm2
        w = weights.to(e.dtype)[..., None, :]  # (..., 1, 3) against (..., P)
        s = _pow(e, w[..., 0]) * _pow(l, w[..., 1]) * _pow(a, w[..., 2])
        return torch.where(_feasible(r, a, area_constr_mm2), s, INF)

    score.area_constr = area_constr_mm2
    return score


def rescore(r: EvalResult, kind: str, area_constr_mm2: float = 150.0) -> torch.Tensor:
    """Re-evaluate stored designs under a different objective / workload set."""
    return make_objective(kind, area_constr_mm2)(r)
