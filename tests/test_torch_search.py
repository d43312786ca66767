"""Port parity for the whole slice: the engine and the joint / separate
search drivers against the JAX package, and the paper's claims on the
port itself.

The whole-slice parity tests replay the reference's randomness: its
uniform blocks are derived exactly as its engine derives them
(``k_ga = split(key)[1]``, ``keys = split(k_ga, G)``, one
``uniform(keys[g], (tot,))`` per generation) and both sides get the same
initial population.  The decoded top designs must then be the same and
their scores agree at rtol 1e-5."""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as rengine
from repro.core import search as rsearch
from repro.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert
from repro_torch.core import engine, ga, search, space
from repro_torch.imc.cost import evaluate_designs
from repro_torch.launch import search as launch

CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def pair():
    r = rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])
    return r, convert.workload_set_from_arrays(r.names, r.feats, r.mask)


def ref_blocks(key, P, G):
    """(G, tot) blocks the reference engine's GA draws for request ``key``."""
    k_ga = jax.random.split(key)[1]
    keys = jax.random.split(k_ga, G)
    tot = ga.block_layout(P, space.N_GENES).tot
    return np.stack([np.asarray(jax.random.uniform(keys[g], (tot,))) for g in range(G)])


def _same_result(res, res_r):
    assert res.workload_names == res_r.workload_names
    assert res.top_designs == res_r.top_designs
    np.testing.assert_array_equal(space.decode_indices_np(res.top_genomes),
                                  space.decode_indices_np(np.asarray(res_r.top_genomes)))
    np.testing.assert_allclose(res.top_scores, res_r.top_scores, rtol=1e-5, atol=0)
    a, b = np.asarray(res.convergence), np.asarray(res_r.convergence)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=1e-5, atol=0)
    assert res.valid == res_r.valid and res.generations == res_r.generations


@pytest.mark.parametrize("backend,ref_backend", [("table", "table"), ("dense", "jnp"),
                                                 ("kernel", "pallas")])
def test_joint_search_replays_reference(pair, backend, ref_backend):
    ws_r, ws = pair
    P, G = 16, 4
    init = np.asarray(rengine.seed_population(jax.random.PRNGKey(42), ws_r, P))
    key = jax.random.PRNGKey(0)
    res_r = rsearch.run_search(key, ws_r, pop_size=P, generations=G,
                               backend=ref_backend, init_genomes=jnp.asarray(init))
    res = search.run_search(0, ws, pop_size=P, generations=G, backend=backend,
                            init_genomes=init, u_blocks=ref_blocks(key, P, G), **CPU)
    _same_result(res, res_r)


@pytest.mark.parametrize("backend,ref_backend", [("table", "table"), ("dense", "jnp")])
def test_separate_search_replays_reference(pair, backend, ref_backend):
    ws_r, ws = pair
    P, G = 16, 4
    init = np.asarray(rengine.seed_population(jax.random.PRNGKey(43), ws_r, P))
    key = jax.random.PRNGKey(1)
    sep_r = rsearch.separate_search(key, ws_r, share_init=jnp.asarray(init),
                                    pop_size=P, generations=G, backend=ref_backend)
    keys = jax.random.split(key, ws_r.n)
    U = np.stack([ref_blocks(keys[i], P, G) for i in range(ws_r.n)])
    sep = search.separate_search(1, ws, share_init=init, u_blocks=U, pop_size=P,
                                 generations=G, backend=backend, **CPU)
    assert list(sep) == list(sep_r)
    for name in ws.names:
        _same_result(sep[name], sep_r[name])


def test_engine_mixed_requests_replay_reference(pair):
    """Heterogeneous requests (workload subsets, objectives, areas) packed
    in one batched GA on both sides."""
    ws_r, ws = pair
    P, G = 12, 3
    specs = [([0], "ela", 150.0), ([1, 2], "edp", 1e9), ([0, 1, 2, 3], "e", 100.0),
             ([3], "l", 150.0)]
    reqs_r, reqs = [], []
    for i, (s, obj, area) in enumerate(specs):
        key = jax.random.PRNGKey(20 + i)
        init = np.asarray(rengine.seed_population(key, ws_r.subset(s), P))
        reqs_r.append(rengine.SearchRequest(
            ws=ws_r.subset(s), objective=obj, area_constr=area, key=key,
            backend="table", pop_size=P, generations=G, init_genomes=init))
        reqs.append(engine.SearchRequest(
            ws=ws.subset(s), objective=obj, area_constr=area, seed=i,
            backend="table", pop_size=P, generations=G, init_genomes=init,
            u_blocks=ref_blocks(key, P, G)))
    out_r = rengine.SearchEngine().run(reqs_r)
    eng = engine.SearchEngine(**CPU)
    out = eng.run(reqs)
    assert eng.launches == 1
    for a, b in zip(out, out_r):
        assert a.objective == b.objective
        _same_result(a, b)


# ----------------------------------------------- the paper's claims, on the port
def test_largest_workload_is_vgg16(pair):
    _, ws = pair
    assert ws.names[engine.largest_workload_index(ws)] == "vgg16"


def test_joint_beats_or_ties_separate_on_set(pair):
    """Re-scored on ALL workloads, the joint search's best is at least as
    good as every separate search's best (5% slack), as the reference's
    own test holds it."""
    _, ws = pair
    joint = search.joint_search(0, ws, pop_size=24, generations=6, **CPU)
    sep = search.separate_search(1, ws, pop_size=24, generations=6, **CPU)
    jbest = joint.top_scores[0]
    assert np.isfinite(jbest)
    for r in sep.values():
        if not len(r.top_genomes):
            continue
        s_all, _ = search.rescore_designs(r.top_genomes, ws, **CPU)
        s_all = s_all[np.isfinite(s_all)]
        if len(s_all):
            assert jbest <= s_all.min() * 1.05


def _best_on_all(rescore, top_genomes, ws):
    """The CLI's ``best_on_all``: a separate winner's best finite score
    re-scored on the whole set, or None."""
    if not len(top_genomes):
        return None
    s_all = np.asarray(rescore(top_genomes, ws)[0])
    fin = s_all[np.isfinite(s_all)]
    return float(fin.min()) if len(fin) else None


def _claim(joint_best, sep_all):
    """(separate winners that fit all CNNs, those beaten or tied by their
    own seed's joint best, those beaten or tied by the best joint over all
    seeds), with the CLI's 5% slack."""
    jmin = min(joint_best)
    return (len(sep_all), sum(joint_best[s] <= b * 1.05 for s, b in sep_all),
            sum(jmin <= b * 1.05 for _, b in sep_all))


def test_cli_claim_per_seed_on_both_packages(pair):
    """The CLI's paper run (8 seeds, pop 40, 10 generations, joint and
    separate, table backend; seeds ``s`` and ``s + 1000``) on the reference
    and on the port, each with its own randomness.  On both the best joint
    search over the 8 seeds beats or ties every separate winner re-scored
    on all CNNs, as ``chip_smoke.py`` holds it.  Per seed the claim can
    miss on both (a GA this short is far from converged); the counts are
    printed (``-s``) for the record."""
    ws_r, ws = pair
    S = 8
    kw = dict(pop_size=40, generations=10, backend="table")
    joint_r = rsearch.joint_search_batched(
        jnp.stack([jax.random.PRNGKey(s) for s in range(S)]), ws_r, **kw)
    joint = search.joint_search_batched(list(range(S)), ws, **kw, **CPU)
    sep_r, sep = [], []
    for s in range(S):
        for x in rsearch.separate_search(jax.random.PRNGKey(s + 1000), ws_r, **kw).values():
            b = _best_on_all(rsearch.rescore_designs, x.top_genomes, ws_r)
            sep_r += [] if b is None else [(s, b)]
        for x in search.separate_search(s + 1000, ws, **kw, **CPU).values():
            b = _best_on_all(lambda g, w: search.rescore_designs(g, w, **CPU),
                             x.top_genomes, ws)
            sep += [] if b is None else [(s, b)]
    for label, jr, sa in (("reference", joint_r, sep_r), ("port (CPU)", joint, sep)):
        jb = [float(r.top_scores[0]) for r in jr]
        assert np.isfinite(jb).all()
        n_fit, per_seed, vs_best = _claim(jb, sa)
        assert vs_best == n_fit
        print(f"\n[claim] {label}: {n_fit} separate winner(s) fit all CNNs; "
              f"{per_seed} beaten or tied by their own seed's joint best, "
              f"{vs_best} by the best joint over {S} seeds ({min(jb):.6g})")


def test_rescore_identity(pair):
    _, ws = pair
    res = search.joint_search(0, ws, pop_size=16, generations=3, **CPU)
    s, _ = search.rescore_designs(res.top_genomes, ws, **CPU)
    np.testing.assert_allclose(s, res.top_scores, rtol=1e-5)


@pytest.mark.parametrize("backend", engine.BACKENDS)
def test_monotone_convergence_and_finite_top(pair, backend):
    _, ws = pair
    res = search.joint_search(3, ws, pop_size=16, generations=4, backend=backend,
                              area_constr=1e9, **CPU)
    conv = res.convergence
    assert (np.diff(conv[np.isfinite(conv)]) <= 0).all()
    assert res.valid and np.isfinite(res.top_scores).all()
    assert res.ga.genomes.shape == (5, 16, space.N_GENES)


def test_seed_population_fits_largest(pair):
    _, ws = pair
    pop = engine.seed_population(0, ws, 16, **CPU)
    wl = ws.subset([engine.largest_workload_index(ws)])
    r = evaluate_designs(space.decode(pop), wl)
    assert bool(r.fits[:, 0].all()) and bool(r.valid.all())


def test_separate_batched_matches_sequential(pair):
    _, ws = pair
    kw = dict(pop_size=12, generations=3, backend="table", **CPU)
    a = search.separate_search(5, ws, batched=True, **kw)
    b = search.separate_search(5, ws, batched=False, **kw)
    for n in ws.names:
        np.testing.assert_array_equal(a[n].ga.genomes, b[n].ga.genomes)
        np.testing.assert_array_equal(a[n].ga.scores, b[n].ga.scores)
        np.testing.assert_array_equal(a[n].top_scores, b[n].top_scores)


@pytest.mark.parametrize("backend", ["table", "dense"])
def test_multi_seed_batched_matches_sequential(pair, backend):
    _, ws = pair
    kw = dict(pop_size=12, generations=3, backend=backend, **CPU)
    batched = search.joint_search_batched([0, 1, 2], ws, **kw)
    for s, rb in enumerate(batched):
        r1 = search.run_search(s, ws, **kw)
        np.testing.assert_array_equal(rb.ga.genomes, r1.ga.genomes)
        np.testing.assert_array_equal(rb.ga.scores, r1.ga.scores)
        assert rb.top_designs == r1.top_designs


def test_share_init_not_consumed(pair):
    _, ws = pair
    init = engine.seed_population(7, ws, 12, **CPU)
    keep = init.clone()
    search.separate_search(2, ws, share_init=init, pop_size=12, generations=2, **CPU)
    assert torch.equal(init, keep)


@pytest.mark.parametrize("pop", [15, 17])
def test_odd_population(pair, pop):
    _, ws = pair
    res = search.joint_search(1, ws, pop_size=pop, generations=3, backend="table", **CPU)
    assert res.ga.genomes.shape == (4, pop, space.N_GENES)
    assert res.ga.scores.shape == (4, pop)


def test_top_unique_matches_reference():
    rng = np.random.default_rng(0)
    g = rng.random((200, space.N_GENES), dtype=np.float32)
    g[100:150] = g[:50]  # duplicate cells
    s = np.where(rng.random(200) < 0.3, np.inf, rng.random(200)).astype(np.float32)
    s[150:160] = np.nan
    s[160:170] = s[:10]  # ties
    for k in (1, 5, 50, 500):
        tg, ts = engine._top_unique(g, s, k)
        tg_r, ts_r = rengine._top_unique(g, s, k)
        np.testing.assert_array_equal(tg, tg_r)
        np.testing.assert_array_equal(ts, ts_r)


def test_entry_points_default_to_cuda_and_raise_without_it(pair, monkeypatch):
    _, ws = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        search.run_search(0, ws, pop_size=8, generations=1)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.SearchEngine()
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--pop", "8", "--gens", "1"])


def test_launch_main_writes_reference_entries(tmp_path):
    out = tmp_path / "search.json"
    rc = launch.main(["--pop", "12", "--gens", "2", "--seeds", "2", "--separate",
                      "--backend", "table", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    entries = json.loads(out.read_text())
    assert [e["seed"] for e in entries] == [0, 1]
    for e in entries:
        assert set(e) == {"seed", "joint_best", "joint_top10", "best_design",
                          "convergence", "wall_s", "separate"}
        assert len(e["convergence"]) == 3
        assert set(e["separate"]) == set(PAPER_WORKLOADS)
        for s in e["separate"].values():
            assert set(s) == {"own_best", "best_design", "failed_frac_on_all",
                              "best_on_all"}
