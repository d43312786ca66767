"""The port's GA segments, the thin epilogue and the segmented engine.

  * N segments of k generations repeat one run of N*k bit for bit
    (``core.ga``: the state carries the run's uniform stream).
  * The thin epilogue picks exactly the host's ``_top_unique`` designs,
    on adversarial ties (duplicate cells, both zero signs, +inf, NaN, odd
    P), and the JAX package's own epilogue picks the same.
  * The segmented engine: the same bits as one launch, retries from the
    last good state, the NaN guard, EngineFault partials, quarantine in
    the service, and a kill after a checkpoint that resumes to the same
    bits.

CPU only, at P <= 16 and G <= 6."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ga as rga
from repro.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro_torch.checkpoint import store
from repro_torch.core import engine as engine_mod
from repro_torch.core import ga, space
from repro_torch.core.engine import (
    EngineFault,
    NonFiniteScoreError,
    SearchEngine,
    SearchRequest,
    _ctx_eval,
    _top_unique,
    empty_partial_result,
    plan_batch,
    plan_key,
)
from repro_torch.imc.tech import TECH
from repro_torch.serve.dse import DSEService, RetryPolicy
from repro_torch.workloads.pack import pack_workloads

CPU = torch.device("cpu")
P, G = 8, 6


@pytest.fixture(scope="module")
def ws():
    return pack_workloads([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _ga_case(ws, pop=P, gens=G, subsets=((0, 1, 2, 3), (1,))):
    """Table-backend eval, its batched ctx, seeded populations and a
    uniform stream for len(subsets) searches."""
    W = max(len(s) for s in subsets)
    eng = SearchEngine(device=CPU)
    reqs = [SearchRequest(ws=ws.subset(list(s)), backend="table", pop_size=pop,
                          generations=gens, objective=("ela", "edp")[i % 2])
            for i, s in enumerate(subsets)]
    tables = eng._tables(reqs, W, TECH)
    ctx = (tables, torch.tensor([0, 1] * len(subsets))[:len(subsets)],
           torch.tensor([150.0] * len(subsets)))
    init = torch.stack([engine_mod.seed_population(i, r.ws, pop, device=CPU)
                        for i, r in enumerate(reqs)])
    tot = ga.block_layout(pop, space.N_GENES).tot
    u = torch.rand((gens, len(subsets), tot), generator=_gen(7))
    return _ctx_eval(TECH, "table"), ctx, init, u


# ------------------------------------------------------------ GA segments
@pytest.mark.parametrize("splits", [(6,), (3, 3), (2, 2, 2), (1, 5), (4, 2)],
                         ids=lambda s: "+".join(map(str, s)))
def test_segments_bit_identical_to_one_run(ws, splits):
    ev, ctx, init, u = _ga_case(ws)
    one = ga.run_ga_batched(ev, pop_size=P, generations=G, init_genomes=init,
                            ctx=ctx, u_blocks=u)
    st = ga.init_ga_state_batched(ev, init, u, ctx)
    hg, hs = [st.genomes[:, None]], [st.scores[:, None]]
    for k in splits:
        st, (g, s) = ga.run_ga_batched_segment(st, ev, generations=k,
                                               total_generations=G, ctx=ctx)
        hg.append(g)
        hs.append(s)
    assert st.gen == G
    assert torch.equal(torch.cat(hg, dim=1), one.genomes)
    assert torch.equal(torch.cat(hs, dim=1), one.scores)


def test_segments_odd_population_and_unbatched(ws):
    ev, ctx, init, u = _ga_case(ws, pop=7, gens=4, subsets=((0, 2),))
    one_ctx = (type(ctx[0])(*(f[0] for f in ctx[0])), ctx[1][0], ctx[2][0])
    one = ga.run_ga(ev, pop_size=7, generations=4, init_genomes=init[0], ctx=one_ctx,
                    u_blocks=u[:, 0])
    st = ga.init_ga_state(ev, init[0], u[:, 0], one_ctx)
    hist = [st.genomes[0][None]]
    for k in (1, 3):
        st, (g, _) = ga.run_ga_segment(st, ev, generations=k, total_generations=4,
                                       ctx=one_ctx)
        hist.append(g)
    assert torch.equal(torch.cat(hist), one.genomes)


def test_segment_leaves_its_state_and_checks_bounds(ws):
    ev, ctx, init, u = _ga_case(ws)
    st = ga.init_ga_state_batched(ev, init, u, ctx)
    keep = st.genomes.clone()
    a, _ = ga.run_ga_batched_segment(st, ev, generations=2, total_generations=G, ctx=ctx)
    b, _ = ga.run_ga_batched_segment(st, ev, generations=2, total_generations=G, ctx=ctx)
    assert torch.equal(st.genomes, keep) and st.gen == 0
    assert torch.equal(a.genomes, b.genomes)
    with pytest.raises(ValueError, match="exceeds"):
        ga.run_ga_batched_segment(a, ev, generations=5, total_generations=G, ctx=ctx)
    with pytest.raises(ValueError, match="total_generations"):
        ga.run_ga_batched_segment(st, ev, generations=1, total_generations=G + 1, ctx=ctx)


# ---------------------------------------------------------- thin epilogue
def _epilogue_vs_host(hist_g, hist_s, top_k):
    """The port's thin epilogue against the host ``_top_unique`` (the
    sequential finalize) and against the JAX package's epilogue."""
    G1, Pn, n = hist_g.shape
    thin = ga.ga_epilogue_batched(torch.from_numpy(hist_g[None]),
                                  torch.from_numpy(hist_s[None]), top_k=top_k)
    kept = int(thin.n_kept[0])
    tg, ts = _top_unique(hist_g.reshape(-1, n), hist_s.reshape(-1), top_k)
    assert kept == len(ts)
    np.testing.assert_array_equal(thin.top_genomes[0, :kept].numpy(), tg)
    np.testing.assert_array_equal(thin.top_scores[0, :kept].numpy(), ts)
    assert np.isinf(thin.top_scores[0, kept:].numpy()).all()
    assert not thin.top_genomes[0, kept:].numpy().any()
    np.testing.assert_array_equal(thin.convergence[0].numpy(),
                                  np.minimum.accumulate(hist_s.min(axis=1)))
    ref = rga.ga_epilogue_batched(hist_g[None], hist_s[None], top_k=top_k)
    assert int(ref.n_kept[0]) == kept
    np.testing.assert_array_equal(np.asarray(ref.top_genomes[0]), thin.top_genomes[0].numpy())
    np.testing.assert_array_equal(np.asarray(ref.top_scores[0]), thin.top_scores[0].numpy())


def test_epilogue_adversarial_ties():
    """Duplicate cells, +-inf, NaN and a -0.0/+0.0 tie: the host's stable
    first occurrence of each cell, non-finite dropped."""
    rng = np.random.default_rng(0)
    Gh, Ph = 4, 8
    base = rng.random((Ph, space.N_GENES), dtype=np.float32)
    g = np.tile(base[None], (Gh, 1, 1)).astype(np.float32)
    g[:, 1] = g[:, 0]
    g[1, 0] = np.clip(g[0, 0] + 1e-4, 0.0, 1.0 - 1e-7).astype(np.float32)
    assert np.array_equal(space.decode_indices_np(g[1, 0][None]),
                          space.decode_indices_np(g[0, 0][None]))
    s = (np.abs(rng.standard_normal((Gh, Ph))) + 1.0).astype(np.float32)
    s[0, 0], s[1, 0] = -0.0, +0.0
    s[0, 3] = s[1, 3] = np.inf
    s[2, 5] = np.nan
    _epilogue_vs_host(g, s, top_k=5)


@pytest.mark.parametrize("Ph", [7, 9])
def test_epilogue_odd_population_and_topk_over_n(Ph):
    rng = np.random.default_rng(Ph)
    g = rng.random((3, Ph, space.N_GENES), dtype=np.float32)
    s = rng.random((3, Ph), dtype=np.float32)
    s[1, ::2] = s[0, ::2]  # equal scores across generations
    _epilogue_vs_host(g, s, top_k=3)
    _epilogue_vs_host(g, s, top_k=64)


def test_epilogue_all_infeasible_and_equal_scores():
    rng = np.random.default_rng(3)
    g = rng.random((2, 4, space.N_GENES), dtype=np.float32)
    _epilogue_vs_host(g, np.full((2, 4), np.inf, np.float32), top_k=3)
    _epilogue_vs_host(g, np.zeros((2, 4), np.float32), top_k=8)


# ---------------------------------------------------------- segmented engine
def _reqs(ws, n, backend="table", gens=G, seed0=0):
    subsets = [[0, 1, 2, 3], [0], [1, 2]]
    return [SearchRequest(ws=ws.subset(subsets[i % 3]), seed=seed0 + i, backend=backend,
                          pop_size=P, generations=gens, top_k=(3, 7)[i % 2])
            for i in range(n)]


def _same(a, b):
    np.testing.assert_array_equal(a.top_scores, b.top_scores)
    np.testing.assert_array_equal(a.top_genomes, b.top_genomes)
    np.testing.assert_array_equal(a.convergence, b.convergence)
    assert a.top_designs == b.top_designs
    assert (a.valid, a.generations, a.objective, a.workload_names) == \
        (b.valid, b.generations, b.objective, b.workload_names)
    if a.ga is not None and b.ga is not None:
        np.testing.assert_array_equal(a.ga.genomes, b.ga.genomes)
        np.testing.assert_array_equal(a.ga.scores, b.ga.scores)


@pytest.mark.parametrize("backend", ["table", "dense"])
@pytest.mark.parametrize("pipelined", [False, True])
def test_segmented_engine_matches_one_launch(ws, backend, pipelined):
    reqs = _reqs(ws, 3, backend, gens=5)  # 2 + 2 + 1: a ragged last segment
    ref = SearchEngine(device=CPU).run(reqs)
    out = SearchEngine(device=CPU, segment_gens=2, pipelined=pipelined).run(reqs)
    for a, b in zip(out, ref):
        _same(a, b)
        assert (a.ga is None) == pipelined


def test_segment_gens_at_or_above_budget_is_one_launch(ws, monkeypatch):
    calls = []
    monkeypatch.setattr(engine_mod, "run_ga_batched_segment",
                        lambda *a, **k: calls.append(1))
    eng = SearchEngine(device=CPU, segment_gens=G)
    eng.run(_reqs(ws, 2))
    assert not calls and eng.launches == 1


def _flaky(monkeypatch, fail_on=(), nan_on=()):
    real = engine_mod.run_ga_batched_segment
    calls = {"n": 0}

    def seg(*a, **kw):
        calls["n"] += 1
        if calls["n"] in fail_on:
            raise RuntimeError("injected launch failure")
        st, (hg, hs) = real(*a, **kw)
        if calls["n"] in nan_on or nan_on == "always":
            hs = torch.full_like(hs, float("nan"))
        return st, (hg, hs)

    monkeypatch.setattr(engine_mod, "run_ga_batched_segment", seg)
    return calls


@pytest.mark.parametrize("fault", ["fail", "nan"])
def test_failed_segment_retries_from_last_good_state(ws, monkeypatch, fault):
    reqs = _reqs(ws, 2)
    ref = SearchEngine(device=CPU).run(reqs)
    calls = _flaky(monkeypatch, **({"fail_on": (2,)} if fault == "fail" else {"nan_on": (2,)}))
    out = SearchEngine(device=CPU, segment_gens=2, segment_retries=1).run(reqs)
    assert calls["n"] == 4  # 3 segments, one of them twice
    for a, b in zip(out, ref):
        _same(a, b)


def test_exhausted_retries_raise_with_partials(ws, monkeypatch):
    reqs = _reqs(ws, 2)
    _flaky(monkeypatch, nan_on=(2, 3))
    with pytest.raises(EngineFault) as ei:
        SearchEngine(device=CPU, segment_gens=2, segment_retries=1).run(reqs)
    fault = ei.value
    assert isinstance(fault.__cause__, NonFiniteScoreError)
    assert fault.generations_done == 2
    full = SearchEngine(device=CPU, segment_gens=2).run(reqs)
    for p, r, f in zip(fault.partials, reqs, full):
        assert p.partial and p.generations == 2 and p.workload_names == r.ws.names
        np.testing.assert_array_equal(p.convergence, f.convergence[:3])
        assert np.isfinite(p.top_scores).all() and p.valid == bool(p.top_scores.size)


def test_nan_seed_evaluation_raises(ws, monkeypatch):
    real = engine_mod.init_ga_state_batched

    def nan_state(*a, **kw):
        st = real(*a, **kw)
        return st._replace(scores=torch.full_like(st.scores, float("nan")))

    monkeypatch.setattr(engine_mod, "init_ga_state_batched", nan_state)
    with pytest.raises(NonFiniteScoreError, match="seed"):
        SearchEngine(device=CPU, segment_gens=2).run(_reqs(ws, 1))


def test_nan_segment_retried_then_quarantined_with_partial(ws, monkeypatch):
    """The service's retry lane re-plans a failing request alone; when its
    segments keep coming back NaN it is quarantined with its best so far."""
    calls = _flaky(monkeypatch, nan_on="always")
    clock = {"t": 0.0}
    svc = DSEService(engine=SearchEngine(device=CPU, segment_gens=2, segment_retries=0),
                     retry=RetryPolicy(max_attempts=2, backoff_s=1.0, jitter=0.0),
                     partial_results=True, clock=lambda: clock["t"],
                     sleep=lambda dt: clock.__setitem__("t", clock["t"] + dt))
    rids = svc.submit_all(_reqs(ws, 2))
    res = svc.drain()
    assert calls["n"] == 3  # the shared launch, then each request alone
    assert svc.stats.failures == 4 and svc.stats.retries == 2 and svc.stats.partials == 2
    assert svc.launch_log == []  # no launch completed
    for rid in rids:
        assert res[rid].partial and res[rid].generations == 0


def test_empty_partial_result_contract(ws):
    r = empty_partial_result(_reqs(ws, 1)[0])
    assert r.partial and not r.valid and r.generations == 0 and r.ga is None
    assert r.top_genomes.shape == (0, space.N_GENES) and r.top_designs == []


# -------------------------------------------------------------- kill/resume
class _Killed(BaseException):
    pass


def _kill_after_first_save(monkeypatch):
    real = store.save

    def save(*a, **kw):
        real(*a, **kw)
        raise _Killed()

    monkeypatch.setattr(store, "save", save)
    return real


def test_kill_after_checkpoint_resumes_to_the_same_bits(ws, tmp_path, monkeypatch):
    reqs = _reqs(ws, 2, seed0=50)
    ref = SearchEngine(device=CPU).run(reqs)
    real = _kill_after_first_save(monkeypatch)
    with pytest.raises(_Killed):
        SearchEngine(device=CPU, segment_gens=2, checkpoint_dir=str(tmp_path)).run(reqs)
    monkeypatch.setattr(store, "save", real)
    ck = tmp_path / plan_key(plan_batch(reqs)[0], CPU)
    assert store.latest_step(ck) == 2
    calls = _flaky(monkeypatch)
    out = SearchEngine(device=CPU, segment_gens=2, checkpoint_dir=str(tmp_path)).run(reqs)
    assert calls["n"] == 2  # generations 2-6 only
    for a, b in zip(out, ref):
        _same(a, b)
    assert store.latest_step(ck) is None  # a finished plan clears its state


def test_service_drain_kill_resume(ws, tmp_path, monkeypatch):
    reqs = _reqs(ws, 2, seed0=80)
    ref = SearchEngine(device=CPU).run(reqs)
    real = _kill_after_first_save(monkeypatch)
    svc = DSEService(engine=SearchEngine(device=CPU, segment_gens=2,
                                         checkpoint_dir=str(tmp_path)))
    svc.submit_all(reqs)
    with pytest.raises(_Killed):
        svc.drain()
    assert svc.pending() == len(reqs)  # rolled back, still queued
    monkeypatch.setattr(store, "save", real)
    svc2 = DSEService(engine=SearchEngine(device=CPU, segment_gens=2, pipelined=True,
                                          checkpoint_dir=str(tmp_path)))
    rids = svc2.submit_all(reqs)
    res = svc2.drain()
    for rid, b in zip(rids, ref):
        _same(res[rid], b)


def test_checkpoint_cadence(ws, tmp_path, monkeypatch):
    saves = []
    real = store.save
    monkeypatch.setattr(store, "save", lambda d, step, leaves, **kw:
                        (saves.append(step), real(d, step, leaves, **kw))[1])
    SearchEngine(device=CPU, segment_gens=1, checkpoint_every=2,
                 checkpoint_dir=str(tmp_path)).run(_reqs(ws, 1, gens=5))
    assert saves == [2, 4]


def test_plan_key_names_the_device_and_given_blocks(ws):
    plan = plan_batch(_reqs(ws, 2))[0]
    assert plan_key(plan, "cpu") != plan_key(plan, "cuda")
    other = dataclasses.replace(plan, requests=[dataclasses.replace(
        plan.requests[0], u_blocks=np.zeros((G, 10), np.float32))] + plan.requests[1:])
    assert plan_key(other, "cpu") != plan_key(plan, "cpu")


def test_streamed_snapshots_are_monotone_prefixes(ws):
    for pipelined in (False, True):
        reqs = _reqs(ws, 2, gens=6)
        full = SearchEngine(device=CPU).run(reqs)
        snaps = {0: [], 1: []}
        eng = SearchEngine(device=CPU, segment_gens=2, pipelined=pipelined)
        plan = plan_batch(reqs)[0]
        res = eng.execute(plan, on_progress=lambda i, s: snaps[i].append(s))
        for i in (0, 1):
            assert [s.generations for s in snaps[i]] == [2, 4]
            for s in snaps[i]:
                assert s.partial
                np.testing.assert_array_equal(
                    s.convergence, full[plan.indices[i]].convergence[:s.generations + 1])
            _same(res[i], full[plan.indices[i]])


def test_store_round_trip_keep_and_uncommitted(tmp_path):
    d = tmp_path / "ck"
    for step in range(5):
        store.save(d, step, [np.arange(step + 1), np.float32(step), np.zeros((2, 3))], keep=2)
    assert sorted(store.committed_steps(d)) == [3, 4]
    (d / "step_000000009.tmp").mkdir()  # a crashed save: never visible
    leaves, step = store.restore(d)
    assert step == 4 and np.array_equal(leaves[0], np.arange(5)) and leaves[2].shape == (2, 3)
    assert store.restore(d, step=3)[0][1] == np.float32(3)
    assert store.scan(tmp_path) == ["ck"]
    store.clear(d)
    assert store.latest_step(d) is None and store.scan(tmp_path) == []
    with pytest.raises(FileNotFoundError):
        store.restore(d)

