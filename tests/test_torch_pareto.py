"""Port parity: NSGA-II survival, the Pareto front epilogue and Pareto
requests through the engine, against the JAX package (the twin of
``tests/test_pareto.py``).

  * Dominance rank, folded-bit crowding, the (rank, -crowding) keys and
    the crowded positions equal the reference functions and its numpy
    oracle bit for bit on adversarial vectors (duplicates, +-0.0, all-+inf
    rows, NaN rows, odd sizes), alone and in a batch.
  * One Pareto generation on the table backend, fed the reference's
    uniform block and tables: children within 1e-6 with the same decoded
    cells (XLA contracts FMAs, as ``tests/test_torch_ga.py`` says), and
    survival fed the same candidate vectors keeps the same designs in the
    same order, bit for bit.
  * The front epilogue over a reference history equals the reference's
    and the oracle's, bit for bit; a smaller ``pareto_k`` is a prefix.
  * Engine: sequential and pipelined fronts, and every ``fused`` setting,
    are the same bits; Pareto requests plan alone, validate eagerly,
    round-trip the result cache, and their scores are the ``ela`` bits of
    their vectors.

CPU only, P <= 40, <= 4 generations, 2 CNNs where a workload set is
searched."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ga as rga
from repro.core import space as rspace
from repro.core.engine import _ctx_eval as r_ctx_eval
from repro.core.objectives import PARETO as RPARETO
from repro.imc import tables as rtables
from repro.imc.tech import TECH as RTECH
from repro.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert
from repro_torch.core import ga, space
from repro_torch.core.engine import SearchEngine, SearchRequest, _ctx_eval, plan_batch
from repro_torch.core.objectives import N_PARETO, PARETO, pareto_scalar
from repro_torch.core.search import rescore_designs, run_search
from repro_torch.imc import tables
from repro_torch.serve.cache import ResultCache, request_key
from test_pareto import (
    _adversarial_objs,
    np_crowded_order_keys,
    np_crowding,
    np_dominance_rank,
    np_pareto_epilogue,
)

CPU = torch.device("cpu")
POP, GENS, K = 12, 4, 6
TECH = convert.tech_from_dict(RTECH._asdict())


@pytest.fixture(scope="module")
def pair():
    r = rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS[:2]])
    return r, convert.workload_set_from_arrays(r.names, r.feats, r.mask)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _port_keys(o: np.ndarray):
    t = torch.from_numpy(o)[None]
    rank = ga._dominance_rank(t)[0].numpy()
    crowd = ga._crowding(t)[0].numpy()
    krank, ckey = (x[0].numpy() for x in ga._crowded_order_keys(t))
    pos = ga._crowded_positions(t)[0].numpy()
    return rank, crowd, krank, ckey, pos


# ------------------------------------------------------------ sort keys
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 2, 7, 40])
def test_sort_keys_match_reference_and_oracle(seed, n):
    o = _adversarial_objs(np.random.default_rng(seed), n)
    rank, crowd, krank, ckey, pos = _port_keys(o)
    r_rank, r_ckey = (np.asarray(x) for x in jax.jit(rga._crowded_order_keys)(jnp.asarray(o)))
    np.testing.assert_array_equal(rank, np.asarray(jax.jit(rga._dominance_rank)(jnp.asarray(o))))
    np.testing.assert_array_equal(rank, np_dominance_rank(o))
    np.testing.assert_array_equal(_bits(crowd), _bits(jax.jit(rga._crowding)(jnp.asarray(o))))
    np.testing.assert_array_equal(_bits(crowd), _bits(np_crowding(o)))
    np.testing.assert_array_equal(krank, r_rank)
    np.testing.assert_array_equal(ckey, r_ckey)
    np.testing.assert_array_equal(ckey, np_crowded_order_keys(o)[1])
    np.testing.assert_array_equal(
        pos, np.asarray(jax.jit(rga._crowded_positions)(jnp.asarray(o))))


def test_sort_keys_of_a_batch_equal_each_alone():
    """Searches of one batch keep their own keys: the front peel runs until
    every search is ranked, and the extra rounds change nothing."""
    objs = [_adversarial_objs(np.random.default_rng(10 + i), 23) for i in range(3)]
    objs[1][:] = np.inf  # one front only
    t = torch.from_numpy(np.stack(objs))
    rank, ckey = ga._crowded_order_keys(t)
    pos = ga._crowded_positions(t)
    for i, o in enumerate(objs):
        one_rank, _, _, one_ckey, one_pos = _port_keys(o)
        np.testing.assert_array_equal(rank[i].numpy(), one_rank)
        np.testing.assert_array_equal(ckey[i].numpy(), one_ckey)
        np.testing.assert_array_equal(pos[i].numpy(), one_pos)


def test_front_peel_past_one_block():
    """A chain of more fronts than one peel block: rank i for row i."""
    n = 3 * ga.PEEL_BLOCK + 5
    o = np.repeat(np.arange(n, dtype=np.float32)[:, None], 3, axis=1)
    rank = ga._dominance_rank(torch.from_numpy(o)[None])[0].numpy()
    np.testing.assert_array_equal(rank, np.arange(n))
    np.testing.assert_array_equal(rank, np_dominance_rank(o))


def test_rank_semantics_small_case():
    o = np.array([
        [1.0, 4.0, 1.0], [4.0, 1.0, 1.0], [2.0, 2.0, 1.0], [2.0, 2.0, 2.0],
        [5.0, 5.0, 5.0], [np.inf] * 3, [np.inf] * 3,
    ], np.float32)
    rank = ga._dominance_rank(torch.from_numpy(o)[None])[0].numpy()
    assert rank.tolist() == [0, 0, 0, 1, 2, 3, 3]
    o2 = np.array([[1.0, 9.0], [5.0, 5.0], [9.0, 1.0]], np.float32)
    crowd = ga._crowding(torch.from_numpy(o2)[None])[0].numpy()
    assert np.isinf(crowd[0]) and np.isinf(crowd[2]) and 0 < crowd[1] < np.inf
    np.testing.assert_array_equal(_bits(crowd), _bits(rga._crowding(jnp.asarray(o2))))


# ------------------------------------------------------ one generation
@pytest.fixture(scope="module")
def tabs():
    ws = rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])
    tr = rtables.build_tables_arrays(ws.feats, ws.mask)
    return tr, convert.tables_from_arrays(tr, device="cpu")


@pytest.mark.parametrize("pop,area", [(12, 150.0), (15, 1e9), (40, 150.0)])
def test_pareto_generation_matches_reference(tabs, pop, area):
    """One NSGA-II generation on the table backend, fed the same block."""
    tr, t = tabs
    ev_r = r_ctx_eval(RPARETO, 0.0, RTECH, "table")
    ctx_r = (tr, jnp.float32(area))
    gen = jax.jit(rga._make_gen_step(ev_r, ctx_r, pop, rspace.N_GENES, rga.SBX_PROB,
                                     rga.SBX_ETA, rga.MUT_ETA, fused=True, pareto=True))
    popg = rspace.random_genomes(jax.random.PRNGKey(pop), pop)
    o0 = ev_r(popg, ctx_r)
    sel0 = rga._crowded_positions(o0)
    k = jax.random.fold_in(jax.random.PRNGKey(5), pop)
    u = jax.random.uniform(k, (ga.block_layout(pop, 9).tot,))
    (p_r, o_r, sel_r), (c_r, co_r) = gen((popg, o0, sel0), k)

    ev = _ctx_eval(TECH, "table", PARETO)
    ctx = (tables.WorkloadTables(*(x[None] for x in t)), torch.tensor([area]))
    objs = ev(_t(popg)[None], ctx)
    np.testing.assert_allclose(objs[0].numpy(), np.asarray(o0), rtol=1e-5)
    sel = ga._crowded_positions(_t(o0)[None])
    np.testing.assert_array_equal(sel[0].numpy(), np.asarray(sel0))
    new_pop, new_objs, new_sel, children, child_objs = ga.pareto_gen_step(
        _t(popg)[None], _t(o0)[None], sel, _t(u)[None], ev, ctx)
    np.testing.assert_allclose(children[0].numpy(), np.asarray(c_r), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(space.decode_indices_np(children[0].numpy()),
                                  rspace.decode_indices_np(np.asarray(c_r)))
    np.testing.assert_allclose(child_objs[0].numpy(), np.asarray(co_r), rtol=1e-5)
    np.testing.assert_array_equal(new_sel[0].numpy(), np.asarray(sel_r))

    # survival fed the reference's candidates keeps its designs, in its order
    allg = torch.cat([_t(popg), _t(c_r)])[None]
    allo = torch.cat([_t(o0), _t(co_r)])[None]
    idx = ga._crowded_order(*ga._crowded_order_keys(allo))[:, :pop]
    np.testing.assert_array_equal(ga._rows(allo, idx)[0].numpy(), np.asarray(o_r))
    np.testing.assert_array_equal(ga._rows(allg, idx)[0].numpy(), np.asarray(p_r))


# ------------------------------------------------------------ epilogue
def _ref_history(B=3):
    """A reference NSGA-II history over a decoded-cell toy objective (the
    one ``tests/test_pareto.py`` runs): duplicate cells and an infeasible
    band, everything the dedup and masking must survive."""
    def toy(genomes, _ctx=None):
        idx = rspace.decode_indices(genomes).astype(jnp.float32)
        objs = jnp.stack([1.0 + idx[:, 0] + 2.0 * idx[:, 1],
                          1.0 + idx[:, 2] + 3.0 * idx[:, 3], 1.0 + idx[:, 4]], axis=-1)
        return jnp.where((idx[:, 5] > 0.0)[:, None], objs, jnp.inf)

    keys = jax.random.split(jax.random.PRNGKey(0), B)
    init = jax.vmap(lambda k: rspace.random_genomes(k, POP))(
        jax.random.split(jax.random.PRNGKey(1), B))
    gh, oh, thin = rga.run_pareto_batched(keys, toy, pop_size=POP, generations=GENS,
                                          init_genomes=init, top_k=K, history=True)
    return np.asarray(gh), np.asarray(oh), thin


def _assert_thin_equal(got: ga.ParetoThin, ref):
    for f in ga.ParetoThin._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_front_epilogue_matches_reference_and_oracle():
    gh, oh, thin_r = _ref_history()
    got = ga.pareto_epilogue_batched(_t(gh), _t(oh), top_k=K)
    _assert_thin_equal(got, thin_r)
    for b in range(gh.shape[0]):
        _assert_thin_equal(ga.ParetoThin(*(f[b] for f in got)),
                           np_pareto_epilogue(gh[b], oh[b], K))


def test_front_epilogue_adversarial_history():
    """NaN, +-0.0, duplicate and all-+inf vectors over random genomes with
    repeated cells, odd P: the reference's epilogue, bit for bit."""
    rng = np.random.default_rng(7)
    G1, P = 3, 9
    gh = rng.random((2, G1, P, 9), dtype=np.float32)
    gh[:, 1, :4] = gh[:, 0, :4]  # repeated cells
    oh = np.stack([_adversarial_objs(rng, G1 * P).reshape(G1, P, 3) for _ in range(2)])
    ref = rga.pareto_epilogue_batched(gh, oh, top_k=20)
    _assert_thin_equal(ga.pareto_epilogue_batched(_t(gh), _t(oh), top_k=20), ref)


def test_pareto_k_is_a_prefix_and_large_k_covers_the_first_front():
    gh, oh, _ = _ref_history(B=1)
    big = ga.pareto_epilogue_batched(_t(gh), _t(oh), top_k=gh.shape[1] * POP)
    small = ga.pareto_epilogue_batched(_t(gh), _t(oh), top_k=2)
    kept = int(small.n_kept[0])
    np.testing.assert_array_equal(small.top_genomes[0, :kept], big.top_genomes[0, :kept])
    flat_o = oh[0].reshape(-1, N_PARETO)
    rank = np_dominance_rank(flat_o)
    n_big = int(big.n_kept[0])
    ranks = [int(rank[(flat_o == v).all(-1)].min()) for v in big.top_vectors[0, :n_big].numpy()]
    assert ranks == sorted(ranks) and ranks[0] == 0
    cells0 = {tuple(c) for c, r, f in zip(space.decode_indices_np(gh[0].reshape(-1, 9)), rank,
                                          np.isfinite(flat_o).all(-1)) if r == 0 and f}
    assert ranks.count(0) == len(cells0)


def test_run_pareto_batched_history_and_thin_agree(pair):
    """``history=True`` returns the history whose epilogue is the thin
    result; each search of a batch equals its run alone."""
    _, ws = pair
    ev = _ctx_eval(TECH, "dense", PARETO)
    B = 3
    feats = ws.feats[None].expand(B, -1, -1, -1)
    mask = ws.mask[None].expand(B, -1, -1)
    ctx = (feats, mask, torch.tensor([150.0, 200.0, 1e9]))
    init = torch.rand((B, POP, 9), generator=torch.Generator().manual_seed(0))
    u = torch.rand((GENS, B, ga.block_layout(POP, 9).tot),
                   generator=torch.Generator().manual_seed(1))
    kw = dict(pop_size=POP, generations=GENS, init_genomes=init, ctx=ctx, u_blocks=u, top_k=K)
    gh, oh, thin = ga.run_pareto_batched(ev, history=True, **kw)
    _assert_thin_equal(ga.run_pareto_batched(ev, **kw), thin)
    _assert_thin_equal(ga.pareto_epilogue_batched(gh, oh, top_k=K), thin)
    assert gh.shape == (B, GENS + 1, POP, 9) and oh.shape == (B, GENS + 1, POP, N_PARETO)
    for i in range(B):
        one = ga.run_pareto_batched(
            ev, pop_size=POP, generations=GENS, init_genomes=init[i:i + 1],
            ctx=(feats[i:i + 1], mask[i:i + 1], ctx[2][i:i + 1]), u_blocks=u[:, i:i + 1],
            top_k=K)
        _assert_thin_equal(one, ga.ParetoThin(*(f[i:i + 1] for f in thin)))


# -------------------------------------------------------------- engine
def _pareto_reqs(ws, backend, n=3):
    return [SearchRequest(ws=ws.subset([i % ws.n, (i + 1) % ws.n]), objective=PARETO,
                          backend=backend, pop_size=POP, generations=GENS, pareto_k=K,
                          seed=i, area_constr=150.0 + 10.0 * (i % 2))
            for i in range(n)]


def _same_front(a, b):
    assert a.objective == b.objective == PARETO
    np.testing.assert_array_equal(a.top_genomes, b.top_genomes)
    np.testing.assert_array_equal(a.top_scores, b.top_scores)
    np.testing.assert_array_equal(a.objective_vectors, b.objective_vectors)
    np.testing.assert_array_equal(a.convergence, b.convergence)
    assert a.top_designs == b.top_designs and a.valid == b.valid


@pytest.mark.parametrize("backend", ["table", "dense"])
def test_sequential_pipelined_and_fused_fronts_are_the_same_bits(pair, backend):
    _, ws = pair
    reqs = _pareto_reqs(ws, backend)
    seq = SearchEngine(device=CPU).run(reqs)
    for eng in (SearchEngine(device=CPU, pipelined=True), SearchEngine(device=CPU, fused=False),
                SearchEngine(device=CPU, fused=True, segment_gens=2)):
        for a, b in zip(seq, eng.run(reqs)):
            _same_front(a, b)
            assert (b.ga is None) == eng.pipelined
    for a in seq:
        kept = len(a.top_scores)
        assert a.objective_vectors.shape == (kept, N_PARETO) and kept <= K
        assert a.ga.genomes.shape == (GENS + 1, POP, 9)
        if a.valid:
            v = a.objective_vectors
            assert not ((v <= v[0]).all(-1) & (v < v[0]).any(-1)).any()
        np.testing.assert_array_equal(
            a.top_scores, (a.objective_vectors[:, 0] * a.objective_vectors[:, 1])
            * a.objective_vectors[:, 2])


def test_pareto_plans_alone_and_validates(pair):
    _, ws = pair
    reqs = [SearchRequest(ws=ws, backend="table", pop_size=POP, generations=GENS),
            SearchRequest(ws=ws, objective=PARETO, backend="table", pop_size=POP,
                          generations=GENS)]
    plans = plan_batch(reqs, max_slots=8)
    assert len(plans) == 2 and any(p.signature[-1] == (PARETO,) for p in plans)
    with pytest.raises(ValueError, match="obj_weights"):
        SearchRequest(ws=ws, objective=PARETO, obj_weights=(1.0, 1.0, 1.0)).signature()
    with pytest.raises(ValueError, match="pareto_k"):
        SearchRequest(ws=ws, objective=PARETO, pareto_k=0).signature()
    with pytest.raises(ValueError, match="pareto"):
        SearchRequest(ws=ws, objective="nope").signature()


def test_run_search_pareto_k_slicing_and_ela_bits(pair):
    """``pareto_k`` threads through ``run_search``; a smaller k is a prefix;
    each member's score is the ``ela`` objective of its design, bit for
    bit, on the dense path."""
    _, ws = pair
    kw = dict(objective=PARETO, pop_size=POP, generations=GENS, backend="dense",
              area_constr=1e9, device=CPU)
    big = run_search(5, ws, pareto_k=K, **kw)
    small = run_search(5, ws, pareto_k=2, **kw)
    n = len(small.top_scores)
    assert big.valid and n == min(2, len(big.top_scores))
    np.testing.assert_array_equal(small.top_genomes, big.top_genomes[:n])
    np.testing.assert_array_equal(small.objective_vectors, big.objective_vectors[:n])
    np.testing.assert_array_equal(
        pareto_scalar(torch.from_numpy(big.objective_vectors)).numpy(), big.top_scores)
    ela, _ = rescore_designs(big.top_genomes, ws, objective="ela", area_constr=1e9,
                             device=CPU)
    np.testing.assert_array_equal(ela, big.top_scores)


def test_pareto_result_cache_round_trip(pair, tmp_path):
    _, ws = pair
    req = _pareto_reqs(ws, "table", n=1)[0]
    stream = SearchEngine(device=CPU).stream
    assert request_key(req, stream) != request_key(
        dataclasses.replace(req, pareto_k=req.pareto_k + 1), stream)
    for pipelined in (True, False):
        d = tmp_path / str(pipelined)
        eng = SearchEngine(device=CPU, pipelined=pipelined,
                           result_cache=ResultCache(disk_dir=d, device=CPU))
        first = eng.run([req])[0]
        launches = eng.launches
        again = eng.run([req])[0]
        assert eng.launches == launches
        fresh = ResultCache(disk_dir=d, device=CPU).get(req)
        for other in (again, fresh):
            _same_front(first, other)
            assert (other.ga is None) == pipelined


def test_service_drains_pareto_requests_alike_in_both_modes(pair):
    """The DSE service accepts Pareto requests (mixed with scalar ones) and
    its sequential and pipelined drains give the same bits."""
    from repro_torch.serve import dse

    _, ws = pair
    mix = dse.paper_request_mix(ws, 8, pop_size=POP, generations=3)
    reqs = [dataclasses.replace(r, objective=PARETO, pareto_k=4) if i % 2 else r
            for i, r in enumerate(mix)]
    out = {}
    for pipelined in (False, True):
        svc = dse.DSEService(engine=SearchEngine(device=CPU, pipelined=pipelined))
        rids = svc.submit_all(reqs)
        res = svc.drain()
        out[pipelined] = [res[r] for r in rids]
    for i, (a, b) in enumerate(zip(out[False], out[True])):
        if i % 2:
            _same_front(a, b)
        else:
            np.testing.assert_array_equal(a.top_scores, b.top_scores)
            assert a.objective_vectors is None and a.top_designs == b.top_designs
