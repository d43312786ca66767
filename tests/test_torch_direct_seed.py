"""Port parity: the direct feasible-cell seeder against the JAX package's,
and the rejection seeder's pools kept as they were.

  * The feasible-cell CDF and the (V, Tc) validity mask equal the
    reference's; given the reference's uniforms (``jax.random.uniform`` of
    the seeding key), the sampled cells and the genomes equal the
    reference's ``_seed_direct`` bit for bit.
  * Every direct seed fits its request's largest workload and is
    V/f-valid; a workload that fits nowhere reports count 0.
  * ``SearchEngine(direct_seed=True)`` seeds table plans that way (other
    backends keep the rejection seeder, as in the reference), and crossed
    with segments it equals the single shot (the twin of
    ``tests/test_ga_segments.py::test_segmented_engine_direct_seed_parity``).
  * The rejection seeder (the default) draws the pools it drew before its
    rounds moved to a stream of their own: fixed-seed digests.

CPU only, P <= 40."""
from __future__ import annotations

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as rengine
from repro.imc.tech import TECH as RTECH
from repro.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert
from repro_torch.core import engine, space
from repro_torch.core.engine import SearchEngine, SearchRequest
from repro_torch.imc.cost import evaluate_designs_arrays, valid_vt_mask
from repro_torch.workloads.lm import lm_workload
from repro_torch.configs.base import get_config
from repro_torch.workloads.pack import pack_workloads

CPU = torch.device("cpu")
TECH = convert.tech_from_dict(RTECH._asdict())
SUBSETS = [[0], [1], [2, 3], [0, 1, 2, 3]]


@pytest.fixture(scope="module")
def pair():
    r = rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])
    return r, convert.workload_set_from_arrays(r.names, r.feats, r.mask)


def _ref_cdf(ws_r):
    w = np.asarray(rengine._workload_weights(ws_r.feats, ws_r.mask))
    demand = np.asarray(ws_r.tables(RTECH).demand)
    return rengine._seed_cells_cdf(demand[int(np.argmax(w))])


def test_vt_mask_matches_reference():
    np.testing.assert_array_equal(valid_vt_mask(TECH).numpy(), rengine._valid_vt_mask(RTECH))


@pytest.mark.parametrize("sub", SUBSETS, ids=str)
@pytest.mark.parametrize("seed,pop", [(0, 40), (3, 7)])
def test_direct_seed_matches_reference(pair, sub, seed, pop):
    ws_r, ws = pair
    wr, wt = ws_r.subset(sub), ws.subset(sub)
    cdf = SearchEngine(device=CPU)._request_seed_cdf(SearchRequest(ws=wt, backend="table"))
    cdf_r = _ref_cdf(wr)
    np.testing.assert_array_equal(cdf, cdf_r)
    key = jax.random.PRNGKey(seed)
    pool_r, count_r = rengine._seed_direct(key, jnp.asarray(cdf_r), pop, RTECH)
    u = jax.random.uniform(key, (pop, space.N_GENES + 2))
    pool, count = engine._seed_direct(torch.from_numpy(np.array(u))[None],
                                      torch.from_numpy(cdf)[None], TECH)
    assert int(count[0]) == int(count_r) == pop
    np.testing.assert_array_equal(space.decode_indices_np(pool[0].numpy()),
                                  np.asarray(rengine.space.decode_indices(pool_r)))
    np.testing.assert_array_equal(pool[0].numpy(), np.asarray(pool_r))


def _largest(ws):
    i = engine.largest_workload_index(ws)
    return ws.feats[i], ws.mask[i]


@pytest.mark.parametrize("sub", SUBSETS, ids=str)
def test_every_direct_seed_fits_and_is_valid(pair, sub):
    _, ws = pair
    wt = ws.subset(sub)
    eng = SearchEngine(device=CPU, direct_seed=True)
    cdf = eng._stacked_seed_cdf([SearchRequest(ws=wt, backend="table")] * 2, TECH)
    u = torch.rand((2, 40, space.N_GENES + 2), generator=torch.Generator().manual_seed(1))
    pools, counts = engine._seed_direct(u, cdf, TECH)
    assert counts.tolist() == [40, 40]
    feats, mask = _largest(wt)
    r = evaluate_designs_arrays(space.decode(pools), feats[None, None], mask[None, None], TECH)
    assert bool(r.fits.all()) and bool(r.valid.all())


def test_direct_seed_reports_a_workload_that_fits_nowhere():
    ws = pack_workloads([("mixtral-8x7b", lm_workload(get_config("mixtral-8x7b")))])
    cdf = SearchEngine(device=CPU)._request_seed_cdf(SearchRequest(ws=ws, backend="table"))
    assert cdf[-1] == 0
    _, counts = engine._seed_direct(torch.rand((1, 4, space.N_GENES + 2)),
                                    torch.from_numpy(cdf)[None], TECH)
    assert counts.tolist() == [0]
    req = SearchRequest(ws=ws, backend="table", pop_size=4, generations=1)
    with pytest.raises(RuntimeError, match="could not seed"):
        SearchEngine(device=CPU, direct_seed=True).run([req])


def _reqs(ws, backend, n=3, seed0=60):
    return [SearchRequest(ws=ws.subset(SUBSETS[i % len(SUBSETS)]), backend=backend,
                          objective=("ela", "edp", "l")[i % 3], seed=seed0 + i,
                          pop_size=16, generations=4)
            for i in range(n)]


def _same(a, b):
    np.testing.assert_array_equal(a.top_scores, b.top_scores)
    np.testing.assert_array_equal(a.top_genomes, b.top_genomes)
    np.testing.assert_array_equal(a.convergence, b.convergence)
    assert a.top_designs == b.top_designs


def test_engine_direct_seeds_table_plans_only(pair):
    _, ws = pair
    reqs = _reqs(ws, "table")
    direct = SearchEngine(device=CPU, direct_seed=True).run(reqs)
    for r, d in zip(reqs, direct):
        g_seed, _ = engine._slot_generators(r.seed, CPU)
        u = torch.rand((16, space.N_GENES + 2), generator=g_seed)
        cdf = SearchEngine(device=CPU)._request_seed_cdf(r)
        pool, _ = engine._seed_direct(u[None], torch.from_numpy(cdf)[None], TECH)
        np.testing.assert_array_equal(d.ga.genomes[0], pool[0].numpy())
    # the other backends keep the rejection seeder
    dense = _reqs(ws, "dense", n=1)
    for a, b in zip(SearchEngine(device=CPU, direct_seed=True).run(dense),
                    SearchEngine(device=CPU).run(dense)):
        np.testing.assert_array_equal(a.ga.genomes, b.ga.genomes)


def test_segmented_engine_direct_seed_parity(pair):
    _, ws = pair
    reqs = _reqs(ws, "table")
    ref = SearchEngine(device=CPU, direct_seed=True).run(reqs)
    for eng in (SearchEngine(device=CPU, direct_seed=True, segment_gens=2, fused=True),
                SearchEngine(device=CPU, direct_seed=True, segment_gens=2, pipelined=True)):
        for a, b in zip(eng.run(reqs), ref):
            _same(a, b)


# ---------------------------------------------- rejection pools unchanged
def _digest(pools) -> str:
    return hashlib.sha256(pools.numpy().tobytes()).hexdigest()


def test_rejection_pools_unchanged_on_fixed_seeds(pair):
    """Digests of the pools the rejection seeder drew before its early exit
    read an event of its own stream: one round fills three slots; one
    oversample and 8 rounds leave a slot short."""
    _, ws4 = pair
    ws = ws4.subset([0, 1])
    reqs = [ws, ws.subset([1]), ws.subset([0])]
    L = max(int(w.feats.shape[1]) for w in reqs)
    feats = torch.zeros((3, 2, L, 6))
    mask = torch.zeros((3, 2, L), dtype=torch.bool)
    for i, w in enumerate(reqs):
        a, b = w.feats.shape[:2]
        feats[i, :a, :b], mask[i, :a, :b] = w.feats, w.mask
    gens = [engine._slot_generators(s, CPU)[0] for s in (3, 11, 42)]
    pools, counts = engine._seed_pools(gens, feats, mask, 24, tech=TECH)
    assert counts.tolist() == [24, 24, 24]
    assert _digest(pools) == "d77a64b873934c5598cc12aa820652b537d50e96fed42824b9d3d44493283de2"
    pools, counts = engine._seed_pools([engine._slot_generators(7, CPU)[0]], feats[:1],
                                       mask[:1], 40, tech=TECH, oversample=1, max_rounds=8)
    assert counts.tolist() == [7]
    assert _digest(pools) == "f2d56c2f8081135666993533ba6a0be042d19d8fa12860d84ca54b93972df8fc"
    both = ws.feats[None].expand(2, -1, -1, -1), ws.mask[None].expand(2, -1, -1)
    pools, counts = engine._seed_pools([engine._slot_generators(s, CPU)[0] for s in (5, 9)],
                                       *both, 6, tech=TECH, oversample=1, max_rounds=8)
    assert counts.tolist() == [1, 2]
    assert _digest(pools) == "2e8f1b1da56d936d19f4e252e013b54e953de0dd8f5a65424f6458f32157e2b9"


def test_default_engine_seeds_with_the_rejection_pools(pair):
    _, ws = pair
    reqs = _reqs(ws, "table")
    eng = SearchEngine(device=CPU)
    plan = engine.plan_batch(reqs)[0]
    feats, mask = eng._packed(plan.requests, plan.pad_w, plan.pad_l)
    gens = [engine._slot_generators(r.seed, CPU)[0] for r in plan.requests]
    pools, _ = engine._seed_pools(gens, feats, mask, 16, tech=TECH)
    for i, res in enumerate(eng.run(plan.requests)):
        np.testing.assert_array_equal(res.ga.genomes[0], pools[i].numpy())
