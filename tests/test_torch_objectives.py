"""Port parity: the exponent-weighted objective family against the JAX
package, and the ``fused`` knob.

  * ``make_weighted_objective`` on the same cost-model outputs scores
    within rtol 1e-5 of the reference's (``x ** w`` need not be the same
    bits on both sides), and each kind's ``OBJECTIVE_WEIGHTS`` row gives
    that kind's bits exactly.
  * Weights (1, 1, 1) against the indexed ``ela`` through the search
    drivers on the dense and table backends (the twins of
    ``tests/test_search_batched.py::test_batched_obj_weights_matches_plain``
    and ``tests/test_tables.py::test_batched_search_table_obj_weights``,
    which hold rtol 1e-5; the port gives the same bits).
  * A weighted search given the reference's initial population and
    uniform blocks replays the reference's (same decoded designs, scores
    rtol 1e-5); a segmented weighted run equals the single shot; mixed
    weights in one plan equal each request alone; ``fused`` in
    {None, True, False} gives the same bits.

CPU only, P <= 16, <= 4 generations, 2 CNNs."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import objectives as robj
from repro.core import space as rspace
from repro.core.search import batched_search as r_batched_search
from repro.imc.cost import evaluate_designs as r_evaluate
from repro.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert
from repro_torch.core import engine, ga, space
from repro_torch.core.engine import SearchEngine, SearchRequest
from repro_torch.core.objectives import (
    OBJECTIVE_WEIGHTS,
    OBJECTIVES,
    make_objective,
    make_weighted_objective,
    rescore,
)
from repro_torch.core.search import batched_search, joint_search_batched
from repro_torch.imc.cost import EvalResult

CPU = torch.device("cpu")
POP, GENS = 12, 4
WEIGHTS = [OBJECTIVE_WEIGHTS[k] for k in OBJECTIVES] + [(0.5, 2.0, 1.5), (1.0, 0.25, 3.0)]


@pytest.fixture(scope="module")
def pair():
    r = rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS[:2]])
    return r, convert.workload_set_from_arrays(r.names, r.feats, r.mask)


@pytest.fixture(scope="module")
def evals(pair):
    """The reference's cost-model outputs of 64 random designs, as both
    packages' ``EvalResult``."""
    ws_r, _ = pair
    g = rspace.random_genomes(jax.random.PRNGKey(0), 64)
    r = r_evaluate(rspace.decode(g), ws_r)
    t = EvalResult(*(torch.from_numpy(np.array(f)) for f in r))
    return r, t


@pytest.mark.parametrize("w", WEIGHTS, ids=[str(w) for w in WEIGHTS])
@pytest.mark.parametrize("area", [150.0, 1e9])
def test_weighted_scores_match_reference(evals, w, area):
    r, t = evals
    ref = np.asarray(robj.make_weighted_objective(area)(r, jnp.asarray(w, jnp.float32)))
    got = make_weighted_objective(area)(t, torch.tensor(w)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.any() or area < 1e9  # random designs rarely fit under 150 mm^2
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=0)


@pytest.mark.parametrize("kind", OBJECTIVES)
def test_kind_weights_give_the_kind_bits(evals, kind):
    _, t = evals
    w = torch.tensor(OBJECTIVE_WEIGHTS[kind])
    np.testing.assert_array_equal(make_weighted_objective(1e9)(t, w).numpy(),
                                  make_objective(kind, 1e9)(t).numpy())
    np.testing.assert_array_equal(rescore(t, kind, 1e9).numpy(),
                                  make_objective(kind, 1e9)(t).numpy())


def test_batched_weights_are_per_search(evals):
    _, t = evals
    tb = EvalResult(*(torch.stack([f, f]) for f in t))
    w = torch.tensor([OBJECTIVE_WEIGHTS["edp"], (0.5, 2.0, 1.5)])
    got = make_weighted_objective(150.0)(tb, w)
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(),
                                      make_weighted_objective(150.0)(t, w[i]).numpy())


def _feats(ws, B):
    return ws.feats[None].expand(B, -1, -1, -1), ws.mask[None].expand(B, -1, -1)


@pytest.mark.parametrize("backend", ["dense", "table"])
def test_ela_weights_equal_the_indexed_ela(pair, backend):
    """Twin of the reference's obj_weights-vs-plain tests: the same bits."""
    _, ws = pair
    feats, mask = _feats(ws, 2)
    kw = dict(pop_size=POP, generations=GENS, backend=backend, device=CPU,
              engine=SearchEngine(device=CPU))
    plain = batched_search([3, 4], feats, mask, **kw)
    weighted = batched_search([3, 4], feats, mask, obj_weights=[(1.0, 1.0, 1.0)] * 2, **kw)
    for a, b in zip(plain, weighted):
        np.testing.assert_array_equal(a.ga.scores, b.ga.scores)
        np.testing.assert_array_equal(a.ga.genomes, b.ga.genomes)
        assert b.objective == "ela"


def _ref_blocks(key, P, G):
    k_ga = jax.random.split(key)[1]
    keys = jax.random.split(k_ga, G)
    tot = ga.block_layout(P, space.N_GENES).tot
    return np.stack([np.asarray(jax.random.uniform(keys[g], (tot,))) for g in range(G)])


@pytest.mark.parametrize("backend", ["dense", "table"])
def test_weighted_search_replays_reference(pair, backend):
    """Given the reference's populations and blocks, a batch of mixed
    weights follows the reference's searches."""
    ws_r, ws = pair
    w = np.array([(1.0, 1.0, 0.0), (0.5, 2.0, 1.5), (1.0, 0.0, 0.0)], np.float32)
    B = len(w)
    keys = jnp.stack([jax.random.PRNGKey(20 + b) for b in range(B)])
    init = np.stack([np.asarray(rspace.random_genomes(jax.random.PRNGKey(30 + b), POP))
                     for b in range(B)])
    feats_r = jnp.broadcast_to(ws_r.feats[None], (B,) + ws_r.feats.shape)
    mask_r = jnp.broadcast_to(ws_r.mask[None], (B,) + ws_r.mask.shape)
    ref = r_batched_search(keys, feats_r, mask_r, obj_weights=w, area_constr=1e9,
                           pop_size=POP, generations=GENS, init_genomes=init,
                           backend={"dense": "jnp", "table": "table"}[backend])
    U = np.stack([_ref_blocks(keys[b], POP, GENS) for b in range(B)])
    feats, mask = _feats(ws, B)
    got = batched_search(list(range(B)), feats, mask, obj_weights=w, area_constr=1e9,
                         pop_size=POP, generations=GENS, init_genomes=init, u_blocks=U,
                         backend=backend, device=CPU, engine=SearchEngine(device=CPU))
    for a, b in zip(got, ref):
        assert a.objective == b.objective
        np.testing.assert_array_equal(space.decode_indices_np(a.ga.genomes.reshape(-1, 9)),
                                      rspace.decode_indices_np(
                                          np.asarray(b.ga.genomes).reshape(-1, 9)))
        np.testing.assert_allclose(a.ga.scores, np.asarray(b.ga.scores), rtol=1e-5)
        np.testing.assert_allclose(a.top_scores, b.top_scores, rtol=1e-5)


def _weighted_reqs(ws, backend="table"):
    weights = [(1.0, 1.0, 0.0), (0.5, 2.0, 1.5), (1.0, 1.0, 1.0), (0.0, 1.0, 0.0)]
    return [SearchRequest(ws=ws.subset([i % ws.n]) if i % 2 else ws, backend=backend,
                          obj_weights=w, seed=40 + i, pop_size=POP, generations=GENS,
                          area_constr=1e9)
            for i, w in enumerate(weights)]


def _same_result(a, b):
    np.testing.assert_array_equal(a.top_scores, b.top_scores)
    np.testing.assert_array_equal(a.top_genomes, b.top_genomes)
    np.testing.assert_array_equal(a.convergence, b.convergence)
    assert a.top_designs == b.top_designs and a.objective == b.objective


def test_segmented_weighted_run_equals_one_shot(pair):
    _, ws = pair
    reqs = _weighted_reqs(ws)
    one = SearchEngine(device=CPU).run(reqs)
    for eng in (SearchEngine(device=CPU, segment_gens=2),
                SearchEngine(device=CPU, segment_gens=3, pipelined=True)):
        for a, b in zip(one, eng.run(reqs)):
            _same_result(a, b)


def test_mixed_weights_in_one_plan_equal_each_alone(pair):
    _, ws = pair
    reqs = _weighted_reqs(ws)
    assert len(engine.plan_batch(reqs)) == 1
    batch = SearchEngine(device=CPU).run(reqs)
    for r, b in zip(reqs, batch):
        _same_result(SearchEngine(device=CPU).run([r])[0], b)
    labels = [b.objective for b in batch]
    assert labels == ["edp", "weighted(0.5, 2.0, 1.5)", "ela", "l"]
    with pytest.raises(ValueError, match="obj_weights"):
        dataclasses.replace(reqs[0], obj_weights=(1.0, 1.0)).signature()


@pytest.mark.parametrize("backend", ["dense", "table"])
def test_fused_settings_give_the_same_bits(pair, backend):
    _, ws = pair
    reqs = [SearchRequest(ws=ws, backend=backend, seed=7, pop_size=POP, generations=GENS),
            _weighted_reqs(ws, backend)[1]]
    base = SearchEngine(device=CPU).run(reqs)
    for fused in (True, False):
        for a, b in zip(base, SearchEngine(device=CPU, fused=fused).run(reqs)):
            _same_result(a, b)
            np.testing.assert_array_equal(a.ga.genomes, b.ga.genomes)
    with pytest.raises(ValueError, match="fused"):
        SearchEngine(device=CPU, fused="yes")
    res = joint_search_batched([1, 2], ws, pop_size=POP, generations=GENS, backend=backend,
                               device=CPU, obj_weights=[(1.0, 1.0, 1.0), (1.0, 0.0, 0.0)],
                               area_constr=1e9)
    assert [r.objective for r in res] == ["ela", "e"]
