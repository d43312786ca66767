"""The comparison that decides ``correct``: the program's answers against the
plain reference (``bench/reference``), once the window has closed.

Every answer the run collected is judged:

* ``unanswered``: requests that never resolved, or resolved with an error;
* ``bad_answers``: answers malformed on their face: a partial answer, no
  design but not marked invalid (or the reverse), more than ``top_k``,
  another workload set or objective than asked, a design whose reported
  values are not its genome's grid cell, a cell twice, scores out of order
  or not finite;
* ``score_gap``: the widest relative gap, over every design of every
  answer, between the score the program reports and the reference's score
  of that design in float64 (1 where one calls it infeasible and the other
  does not);
* ``rank_share_p50``: the median, over the searches, of the rank share of
  the best design returned (``reference.grid``): the share of the grid's
  feasible cells that score strictly better (all of them for a search
  that found no feasible design);
* ``stalled_share``: the share of the searches whose best score never
  improved on their seeded population's (the answer's best-so-far score
  of each generation, ``convergence``, ends where it starts), so that a
  few searches that do not search, a part of a launch left unevolved,
  show where the median rank does not move.  An answer whose
  best-so-far rises, or does not end at its best design's score, is bad.

A search answer carries its request's GA seed: two answers to different
seeds with the same designs, in the same order, are bad (one request's
answer handed to another).

``control=True`` puts the reference computed in bfloat16 in the program's
place: the answers' scores become the bfloat16 reference's scores of the
same designs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bench.reference import grid, model

NAMES = ("score_gap", "rank_share_p50", "stalled_share", "bad_answers", "unanswered")


@dataclasses.dataclass
class Answer:
    names: Tuple[str, ...]  # the workload set asked for
    objective: str
    area: float
    top_k: int = 10
    seed: Optional[int] = None  # the request's GA seed (None: a re-score)
    result: object = None  # a search's SearchResult, its exception, or None
    rescore: bool = False  # a re-score: the designs and the scores below
    genomes: Optional[np.ndarray] = None
    scores: Optional[np.ndarray] = None


def _shape_ok(a: Answer) -> bool:
    """The answer's own fields agree with the request and with each other;
    its best-so-far scores never rise and end at its best design's."""
    r = a.result
    n = len(r.top_scores)
    conv = np.asarray(r.convergence, np.float64).reshape(-1)
    last = float(r.top_scores[0]) if n else math.inf
    with np.errstate(invalid="ignore"):  # inf - inf before a first feasible design
        rises = (np.diff(conv) > 0).any()
    return not (r.partial or bool(r.valid) != (n > 0) or n > a.top_k
                or len(r.top_genomes) != n or len(r.top_designs) != n
                or tuple(r.workload_names) != tuple(a.names) or r.objective != a.objective
                or len(conv) < 2 or rises or conv[-1] != last)


def _stalled(a: Answer) -> bool:
    conv = np.asarray(a.result.convergence, np.float64).reshape(-1)
    return bool(conv[-1] >= conv[0])


def _copied(done: Sequence[Answer]) -> np.ndarray:
    """Per answer, whether an answer to another seed came first with the
    same designs in the same order."""
    first_seed: Dict[bytes, Optional[int]] = {}
    out = np.zeros(len(done), bool)
    for k, a in enumerate(done):
        g = np.ascontiguousarray(a.result.top_genomes, np.float32)
        if not len(g):
            continue
        key = g.tobytes()
        if key not in first_seed:
            first_seed[key] = a.seed
        elif first_seed[key] != a.seed:
            out[k] = True
    return out


def _designs_ok(done: Sequence[Answer]):
    """Per answer, whether its designs are sound: finite scores in order
    (where the objective orders them), no grid cell twice, reported values
    equal to the genome's cell, not another seed's answer.  All answers'
    designs are judged at once; returns (ok (A,), genomes, scores, owner
    (D,) of each design)."""
    counts = np.array([len(a.result.top_scores) for a in done], np.int64)
    owner = np.repeat(np.arange(len(done)), counts)
    n = len(model.FIELDS)
    genomes = np.concatenate([np.asarray(a.result.top_genomes, np.float32).reshape(-1, n)
                              for a in done] or [np.zeros((0, n), np.float32)])
    scores = np.concatenate([np.asarray(a.result.top_scores, np.float64)
                             for a in done] or [np.zeros(0)])
    values = np.array([[d[f] for f in model.FIELDS] for a in done
                       for d in a.result.top_designs], np.float32).reshape(-1, n)
    idx = model.decode(torch.as_tensor(genomes)).numpy()
    grid = np.stack([model.GRID[f][idx[:, j]] for j, f in enumerate(model.FIELDS)], 1)
    wrong = (values != grid).any(1) | ~np.isfinite(scores)
    ordered = np.array([getattr(model.objective(a.objective), "ORDERED", True)
                        for a in done], bool)
    wrong[1:] |= (owner[1:] == owner[:-1]) & (np.diff(scores) < 0) & ordered[owner[1:]]
    strides = np.cumprod(model.SIZES[::-1])[::-1]
    cell = idx @ np.append(strides[1:], 1) + owner * model.N_CELLS
    _, first = np.unique(cell, return_index=True)
    twice = np.ones(len(cell), bool)
    twice[first] = False
    bad = (np.bincount(owner[wrong | twice], minlength=len(done)) > 0) | _copied(done)
    return ~bad, genomes, scores, owner


def _gap(p: np.ndarray, r: np.ndarray) -> float:
    if len(p) == 0:
        return 0.0
    fin_p, fin_r = np.isfinite(p), np.isfinite(r)
    if (fin_p != fin_r).any():
        return 1.0
    both = fin_p & fin_r
    if not both.any():
        return 0.0
    pp, rr = p[both], r[both]
    return float((np.abs(pp - rr) / np.maximum(np.abs(pp), np.abs(rr))).max())


def _key(a: Answer) -> tuple:
    return (tuple(a.names), a.objective, float(a.area))


def compare(answers: Sequence[Answer], layers: Dict[str, list], device,
            control: bool = False) -> Dict[str, object]:
    """The numbers of the comparison, by ``NAMES``, and ``answers`` (how
    many were judged)."""
    unanswered = bad = 0
    items: Dict[tuple, List[Tuple[np.ndarray, np.ndarray]]] = {}
    done = []
    for a in answers:
        if a.rescore:
            if len(a.genomes) != len(a.scores):
                bad += 1
            else:
                items.setdefault(_key(a), []).append((a.genomes, a.scores))
        elif a.result is None or isinstance(a.result, BaseException):
            unanswered += 1
        elif not _shape_ok(a):
            bad += 1
        else:
            done.append(a)
    ok, genomes, scores, owner = _designs_ok(done)
    bad += int((~ok).sum())
    keep = ok[owner]
    first = np.ones(len(owner), bool)
    first[1:] = owner[1:] != owner[:-1]
    best = dict(zip(owner[first].tolist(), model.decode(torch.as_tensor(genomes[first])).numpy()))
    groups: Dict[tuple, List[int]] = {}
    queries = []
    for k, a in enumerate(done):
        if ok[k]:
            groups.setdefault(_key(a), []).append(k)
            queries.append((*_key(a), best.get(k)))
    for key, ks in groups.items():
        sel = keep & np.isin(owner, ks)
        items.setdefault(key, []).append((genomes[sel], scores[sel]))

    feats = {}
    gap = 0.0
    for (names, kind, area), parts in items.items():
        if names not in feats:
            feats[names] = model.workload_tensors([layers[n] for n in names], device)
        g = torch.as_tensor(np.concatenate([p[0] for p in parts]), device=device)
        ref = model.score_genomes(g, *feats[names], kind, area).cpu().numpy()
        if control:
            prog = model.score_genomes(g, *feats[names], kind, area,
                                       dtype=torch.bfloat16).double().cpu().numpy()
        else:
            prog = np.concatenate([p[1] for p in parts]).astype(np.float64)
        gap = max(gap, _gap(prog, ref))

    shares = []
    if queries:
        tables = {n: grid.workload_tables(layers[n], device)
                  for n in sorted({n for q in queries for n in q[0]})}
        shares = grid.rank_shares(tables, queries, device)
    p50 = float(np.median(shares)) if shares else math.nan
    stalled = float(np.mean([_stalled(a) for k, a in enumerate(done) if ok[k]])) \
        if ok.any() else math.nan
    return {"score_gap": gap, "rank_share_p50": p50, "stalled_share": stalled,
            "bad_answers": bad, "unanswered": unanswered, "answers": len(answers)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number is at or under its limit (nan is not)."""
    return numbers["answers"] > 0 and all(
        numbers[k] <= limits[k] for k in NAMES)
