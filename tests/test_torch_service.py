"""The port's DSE service against the JAX package's.

  * ``plan_batch``: the same plans (members, order, slots, padded shape)
    for the same request lists under fifo / priority / edf, with and
    without slot hints, dense backends grouped by exact (W, L).
  * Helpers: ``RetryPolicy.delay_s`` and the ``ServiceStats`` percentiles.
  * Replay: a sequential, a pipelined and a segmented drain of
    ``paper_request_mix`` over the 4 CNNs, each request given the
    reference's initial population and uniform blocks, replay the JAX
    package's ``DSEService`` rid by rid (same decoded top designs, scores
    within rtol 1e-5).
  * The pipelined service falls back to sequential drains on an engine
    without dispatch / harvest, with the results of the requests alone.

CPU only, at pop <= 16, 4 generations and <= 16 requests."""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as rengine
from repro.serve import dse as rdse
from repro.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert
from repro_torch.core import engine, ga, space
from repro_torch.core.engine import SearchEngine, SearchRequest, plan_batch
from repro_torch.serve import dse

CPU = torch.device("cpu")
BACKEND = {"dense": "jnp", "kernel": "pallas", "table": "table"}


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


# ------------------------------------------------------------------- plans
def _spec_requests(pair, specs):
    """The same requests on both sides: (subset, backend, P, G, priority,
    deadline) per spec; a ``"short"`` subset cuts the layer axis, so the
    dense backends see two L."""
    ws_r, ws = pair
    reqs_r, reqs = [], []
    for i, (sub, backend, P, G, prio, dl) in enumerate(specs):
        if sub == "short":
            a = ws_r.subset([1])
            a = rengine.WorkloadSet(names=a.names, feats=a.feats[:, :20], mask=a.mask[:, :20])
            b = convert.workload_set_from_arrays(a.names, a.feats, a.mask)
        else:
            a, b = ws_r.subset(sub), ws.subset(sub)
        kw = dict(seed=i, pop_size=P, generations=G, priority=prio, deadline_s=dl)
        reqs_r.append(rengine.SearchRequest(ws=a, backend=BACKEND[backend], **kw))
        reqs.append(SearchRequest(ws=b, backend=backend, **kw))
    return reqs_r, reqs


def _plans_of(plans):
    return [(p.indices, p.slots, p.pad_w, p.pad_l, len(p.requests)) for p in plans]


SPECS = [
    ([0, 1, 2, 3], "table", 16, 4, 3, 5.0), ([0], "table", 16, 4, 0, None),
    ([1, 2], "dense", 16, 4, 1, 2.0), ([3], "dense", 16, 4, 0, 9.0),
    ("short", "dense", 16, 4, 2, None), ([0, 1], "kernel", 16, 4, 0, 1.0),
    ([2, 3], "kernel", 16, 4, 5, None), ([1], "table", 12, 4, 1, 3.0),
    ([0, 1, 2], "table", 16, 3, 0, None), ([2], "table", 16, 4, 4, 0.5),
    ([3, 0], "dense", 16, 4, 0, 4.0), ("short", "dense", 16, 4, 1, 7.0),
] * 2


@pytest.mark.parametrize("policy", ["fifo", "priority", "edf"])
@pytest.mark.parametrize("max_slots", [64, 3])
@pytest.mark.parametrize("hinted", [False, True])
def test_plan_batch_matches_the_reference(pair, policy, max_slots, hinted):
    reqs_r, reqs = _spec_requests(pair, SPECS)
    hints_r = hints = None
    if hinted:  # a hint of 4 slots for every signature
        hints_r = {r.signature(): 4 for r in reqs_r}
        hints = {r.signature(): 4 for r in reqs}
    ref = rengine.plan_batch(reqs_r, max_slots=max_slots, policy=policy,
                             slot_hints=hints_r)
    got = plan_batch(reqs, max_slots=max_slots, policy=policy, slot_hints=hints)
    assert _plans_of(got) == _plans_of(ref)


@pytest.mark.parametrize("policy", ["fifo", "priority", "edf"])
def test_plan_batch_with_queue_facts_matches_the_reference(pair, policy):
    reqs_r, reqs = _spec_requests(pair, SPECS[:12])
    facts = [(7 * i % 12, i % 4, 1.5 * (i % 5), None if i % 3 == 0 else 2.0 * i)
             for i in range(12)]
    meta_r = [rengine.RequestMeta(seq=s, priority=p, wait_s=w, deadline_s=d)
              for s, p, w, d in facts]
    meta = [engine.RequestMeta(seq=s, priority=p, wait_s=w, deadline_s=d)
            for s, p, w, d in facts]
    pol_r = rengine.PriorityPolicy(aging_s=2.0) if policy == "priority" else policy
    pol = engine.PriorityPolicy(aging_s=2.0) if policy == "priority" else policy
    ref = rengine.plan_batch(reqs_r, max_slots=2, policy=pol_r, meta=meta_r)
    got = plan_batch(reqs, max_slots=2, policy=pol, meta=meta)
    assert _plans_of(got) == _plans_of(ref)


def test_signature_groups_and_left_out_options(pair):
    _, ws = pair
    t1 = SearchRequest(ws=ws.subset([0]), backend="table")
    t4 = SearchRequest(ws=ws, backend="table")
    d1 = SearchRequest(ws=ws.subset([0]), backend="dense")
    d4 = SearchRequest(ws=ws, backend="dense")
    assert t1.signature() == t4.signature()
    assert d1.signature() != d4.signature()
    assert dataclasses.replace(t1, priority=9, deadline_s=1.0).signature() == t1.signature()
    # the Pareto and weighted families plan into groups of their own
    pareto = dataclasses.replace(t1, objective="pareto").signature()
    weighted = dataclasses.replace(t1, obj_weights=(1.0, 1.0, 1.0)).signature()
    assert len({pareto, weighted, t1.signature()}) == 3
    assert pareto[-1] == ("pareto",) and weighted[-1] == ("weighted", 150.0)
    for knob in (dict(fused=True), dict(fused=False), dict(direct_seed=True)):
        eng = SearchEngine(device=CPU, **knob)
        assert (eng.fused, eng.direct_seed) == (knob.get("fused"), "direct_seed" in knob)
    # a mesh must be a DeviceMesh (tests/test_torch_mesh.py runs real ones)
    with pytest.raises(ValueError, match="DeviceMesh"):
        SearchEngine(device=CPU, mesh=object())
    with pytest.raises(ValueError, match="DeviceMesh"):
        dse.DSEService(device=CPU, mesh=object())


def test_get_policy_rejects_unknown():
    with pytest.raises(ValueError):
        engine.get_policy("lifo")
    with pytest.raises(ValueError):
        engine.PriorityPolicy(aging_s=0)
    pol = engine.PriorityPolicy(aging_s=None)
    assert engine.get_policy(pol) is pol


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("kw", [{}, dict(backoff_s=0.2, multiplier=3.0, jitter=0.3),
                                dict(max_backoff_s=1.0), dict(jitter=0.0)])
def test_retry_delays_match_the_reference(kw):
    a, b = dse.RetryPolicy(**kw), rdse.RetryPolicy(**kw)
    for attempt in range(0, 8):
        for rid in (0, 1, 17, 4095, 123456):
            assert a.delay_s(attempt, rid) == b.delay_s(attempt, rid)


def test_service_stats_match_the_reference():
    samples = np.random.default_rng(0).random((50, 3))
    a, b = dse.ServiceStats(), rdse.ServiceStats()
    for st in (a, b):
        for w, lat, gap in samples:
            st.wait_samples.append(float(w))
            st.latency_samples.append(float(lat))
            st.dispatch_gap_samples.append(float(gap))
        st.completed, st.busy_s, st.cache_hits, st.cache_misses = 50, 2.5, 3, 9
    assert a.summary() == b.summary()
    assert dse.ServiceStats().summary() == rdse.ServiceStats().summary()


def test_paper_request_mix_matches_the_reference(pair):
    ws_r, ws = pair
    ra = rdse.paper_request_mix(ws_r, 20, pop_size=12, generations=3,
                                priorities=[3, 0, 1], deadlines_s=[5.0, None])
    pa = dse.paper_request_mix(ws, 20, pop_size=12, generations=3,
                               priorities=[3, 0, 1], deadlines_s=[5.0, None])
    for a, b in zip(pa, ra):
        assert (a.ws.names, a.objective, a.seed, a.priority, a.deadline_s, a.backend) == \
            (b.ws.names, b.objective, b.seed, b.priority, b.deadline_s, b.backend)
        assert a.ws.fingerprint() == b.ws.fingerprint()


# ------------------------------------------------------------------- replay
P, G, N = 16, 4, 16


@pytest.fixture(scope="module")
def replay(pair):
    """The JAX package's service drain of 16 mixed requests, each given an
    initial population, and the port's twins of those requests fed the
    same population and the reference's uniform blocks."""
    ws_r, ws = pair
    reqs_r = rdse.paper_request_mix(ws_r, N, pop_size=P, generations=G)
    reqs = dse.paper_request_mix(ws, N, pop_size=P, generations=G)
    out_r, out = [], []
    for r_r, r in zip(reqs_r, reqs):
        key = r_r.prng_key()
        init = np.asarray(rengine.seed_population(jax.random.fold_in(key, 7), r_r.ws, P))
        out_r.append(dataclasses.replace(r_r, init_genomes=jnp.asarray(init)))
        out.append(dataclasses.replace(r, init_genomes=init, u_blocks=ref_blocks(key, P, G)))
    svc = rdse.DSEService()
    rids = svc.submit_all(out_r)
    res = svc.drain()
    return out, [res[i] for i in rids]


def _same_result(res, res_r):
    assert res.workload_names == res_r.workload_names and res.objective == res_r.objective
    assert res.top_designs == res_r.top_designs
    np.testing.assert_array_equal(space.decode_indices_np(res.top_genomes),
                                  space.decode_indices_np(np.asarray(res_r.top_genomes)))
    np.testing.assert_allclose(res.top_scores, res_r.top_scores, rtol=1e-5, atol=0)
    a, b = np.asarray(res.convergence), np.asarray(res_r.convergence)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=1e-5, atol=0)
    assert res.valid == res_r.valid and res.generations == res_r.generations


@pytest.mark.parametrize("mode", ["sequential", "pipelined", "segmented",
                                  "pipelined_segmented"])
def test_drain_replays_the_reference_service(replay, mode):
    reqs, ref = replay
    eng = SearchEngine(device=CPU, pipelined="pipelined" in mode,
                       segment_gens=2 if "segmented" in mode else None)
    svc = dse.DSEService(engine=eng)
    rids = svc.submit_all(reqs)
    res = svc.drain()
    assert svc.stats.completed == N and eng.launches == 1
    for rid, b in zip(rids, ref):
        _same_result(res[rid], b)
        assert (res[rid].ga is None) == ("pipelined" in mode)


def test_async_drain_replays_the_reference_service(replay):
    reqs, ref = replay
    with dse.AsyncDSEService(device=CPU, policy="priority", pipelined=True) as svc:
        futs = [svc.submit(dataclasses.replace(r, priority=i % 3))
                for i, r in enumerate(reqs)]
        got = [f.result(timeout=300) for f in futs]
    for a, b in zip(got, ref):
        _same_result(a, b)


def test_pipelined_service_falls_back_on_engines_without_dispatch(pair):
    """An engine with only ``execute`` drains sequentially even when the
    service is asked to pipeline, and each result equals its request run
    alone (what the JAX package's version of this test means: its
    request 0 finds no finite design there, alone or in the service)."""
    _, ws = pair

    class MiniEngine:
        max_slots = 4
        result_cache = None

        def execute(self, plan, **kw):
            return SearchEngine(device=CPU).execute(plan)

    svc = dse.DSEService(engine=MiniEngine(), pipelined=True)
    assert not svc._can_pipeline
    reqs = [SearchRequest(ws=ws.subset(s), seed=130 + i, backend="table", pop_size=14,
                          generations=5, top_k=(3, 7)[i % 2])
            for i, s in enumerate(([0, 1, 2, 3], [0]))]
    rids = svc.submit_all(reqs)
    out = svc.drain()
    for rid, r in zip(rids, reqs):
        alone = SearchEngine(device=CPU).run([r])[0]
        np.testing.assert_array_equal(out[rid].top_scores, alone.top_scores)
        np.testing.assert_array_equal(out[rid].top_genomes, alone.top_genomes)
        np.testing.assert_array_equal(out[rid].convergence, alone.convergence)
        assert out[rid].valid == alone.valid


def test_seeder_pools_do_not_depend_on_the_batch(pair):
    """A slot's pool and count are the bits it gets seeded alone: it draws
    from its own generators, and the early exit waits for the whole batch."""
    _, ws = pair
    reqs = dse.paper_request_mix(ws, 9, pop_size=40, generations=2)
    plan = plan_batch(reqs)[0]
    eng = SearchEngine(device=CPU)

    def seed(rs):
        feats, mask = eng._packed(rs, plan.pad_w, plan.pad_l)
        gens = [engine._slot_generators(r.seed, CPU)[0] for r in rs]
        return engine._seed_pools(gens, feats, mask, 40, tech=rs[0].tech, oversample=8)

    pools, counts = seed(plan.requests)
    assert int(counts.min()) == 40
    for i, r in enumerate(plan.requests):
        one, n = seed([r])
        assert torch.equal(one[0], pools[i]) and int(n[0]) == int(counts[i])


def test_pipelined_run_seeds_every_plan_before_the_first_launch(pair, monkeypatch):
    """``run`` on the pipelined engine seeds all its plans before it launches
    the first GA, and its results equal the sequential engine's."""
    _, ws = pair
    reqs = dse.paper_request_mix(ws, 9, pop_size=10, generations=3)
    calls = []
    real_prepare, real_thin = SearchEngine._prepare, engine.run_ga_batched_thin
    monkeypatch.setattr(SearchEngine, "_prepare", lambda self, plan, **kw: (
        calls.append("seed"), real_prepare(self, plan, **kw))[1])
    monkeypatch.setattr(engine, "run_ga_batched_thin", lambda *a, **kw: (
        calls.append("launch"), real_thin(*a, **kw))[1])
    pip = SearchEngine(device=CPU, max_slots=4, pipelined=True).run(reqs)
    assert calls == ["seed"] * 3 + ["launch"] * 3
    seq = SearchEngine(device=CPU, max_slots=4).run(reqs)
    for a, b in zip(seq, pip):
        np.testing.assert_array_equal(a.top_scores, b.top_scores)
        np.testing.assert_array_equal(a.top_genomes, b.top_genomes)
        np.testing.assert_array_equal(a.convergence, b.convergence)


def test_table_requests_score_alike_alone_and_in_mixed_batches(pair):
    """A table-backend request packed with W=1, 2 and 4 batch-mates (tables
    zero-padded to W=4) gives the bits it gives alone."""
    _, ws = pair
    reqs = dse.paper_request_mix(ws, 12, pop_size=10, generations=3)
    batch = SearchEngine(device=CPU).run(reqs)
    for r, b in zip(reqs, batch):
        a = SearchEngine(device=CPU).run([r])[0]
        np.testing.assert_array_equal(a.ga.genomes, b.ga.genomes)
        np.testing.assert_array_equal(a.ga.scores, b.ga.scores)


# --------------------------------------------------------------------- CLI
def test_serve_cli_drains_and_caches(tmp_path, capsys):
    from repro_torch.launch import search as launch

    argv = ["--serve", "8", "--backend", "table", "--pop", "8", "--gens", "2",
            "--device", "cpu", "--result-cache", str(tmp_path / "cache")]
    outs = []
    for i, extra in enumerate(([], ["--pipelined"])):
        out = tmp_path / f"serve{i}.json"
        assert launch.main(argv + extra + ["--out", str(out)]) == 0
        outs.append(json.loads(out.read_text()))
    text = capsys.readouterr().out
    assert "over 1 engine launches" in text and "over 0 engine launches" in text
    assert [e["rid"] for e in outs[0]] == list(range(8)) and outs[0] == outs[1]
    assert set(outs[0][0]) == {"rid", "objective", "workloads", "best", "best_design",
                               "top_scores"}


@pytest.mark.parametrize("extra", [["--serve-async", "--serve-policy", "priority"],
                                   ["--serve-policy", "edf", "--segment-gens", "1",
                                    "--stream-progress", "--partial-results",
                                    "--retry-attempts", "2"]])
def test_serve_cli_options(capsys, extra):
    from repro_torch.launch import search as launch

    assert launch.main(["--serve", "6", "--backend", "kernel", "--pop", "8", "--gens", "2",
                        "--device", "cpu"] + extra) == 0
    text = capsys.readouterr().out
    assert "[serve] drained 6 requests" in text
    assert text.count("-> best=") == 6


def test_serve_cli_defaults_to_cuda(monkeypatch):
    from repro_torch.launch import search as launch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--serve", "4"])
