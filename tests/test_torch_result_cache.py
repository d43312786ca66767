"""The port's result cache (``serve/cache.py``) and what it keys on.

  * ``request_key`` changes with every field the JAX package's does (one
    case per ``TechParams`` field, as ``tests/test_result_cache.py`` pins
    it there), with the given blocks and population, and with the random
    stream's device: the same seed draws other designs on the CPU's and on
    CUDA's generator.  Scheduling metadata never changes it.
  * A hit equals a fresh search bit for bit; partials are refused; the
    memory tier evicts in LRU order; the disk tier serves a fresh cache
    (full and thin results); a second drain makes no launch.
  * ``plan_key`` separates tech, devices and blocks, so a checkpoint is
    never resumed by a foreign plan; the tables memo is a capped LRU.

CPU only; GA runs at pop 8, 4 generations."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import space as rspace
from repro.imc.tech import TECH as RTECH
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert, imc
from repro_torch.core import space
from repro_torch.core.engine import (
    SearchEngine,
    SearchRequest,
    empty_partial_result,
    plan_batch,
    plan_key,
    stream_tag,
)
from repro_torch.imc.tech import TECH
from repro_torch.serve.cache import ResultCache, _decode, _encode, request_key
from repro_torch.serve.dse import DSEService, ServiceStats, paper_request_mix
from repro_torch.workloads import pack
from repro_torch.workloads.cnn import cnn_workload
from repro_torch.workloads.pack import pack_workloads

CPU = torch.device("cpu")
POP, GENS = 8, 4
STREAM = stream_tag("cpu")


@pytest.fixture(scope="module")
def ws():
    return pack_workloads([(n, cnn_workload(n)) for n in ("resnet18", "vgg16")])


def _reqs(ws, n, *, seed0=0, tech=TECH):
    subsets = [[0, 1], [0], [1]]
    return [SearchRequest(ws=ws.subset(subsets[i % 3]), seed=seed0 + i, backend="table",
                          pop_size=POP, generations=GENS, tech=tech)
            for i in range(n)]


@pytest.fixture(scope="module")
def one(ws):
    req = _reqs(ws, 1, seed0=11)[0]
    return req, SearchEngine(device=CPU).run([req])[0]


def _bit_equal(a, b):
    assert (a.objective, a.workload_names, a.valid, a.partial, a.generations) == \
        (b.objective, b.workload_names, b.valid, b.partial, b.generations)
    assert a.top_designs == b.top_designs
    for name in ("top_scores", "top_genomes", "convergence"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.ga is None) == (b.ga is None)
    if a.ga is not None:
        for x, y in zip(a.ga, b.ga):
            np.testing.assert_array_equal(x, y)


def _perturb(tech, field):
    v = getattr(tech, field)
    return tech._replace(**{field: v + 1 if isinstance(v, int) else v * 1.5 + 1e-9})


# ------------------------------------------------------------------- keys
def test_tech_fields_match_the_reference():
    assert TECH._fields == RTECH._fields


@pytest.mark.parametrize("field", TECH._fields)
def test_request_and_plan_keys_change_with_each_tech_field(ws, field):
    base = _reqs(ws, 1)[0]
    other = dataclasses.replace(base, tech=_perturb(TECH, field))
    assert request_key(other, STREAM) != request_key(base, STREAM)
    plan_a, plan_b = plan_batch([base])[0], plan_batch([other])[0]
    assert plan_key(plan_a, CPU) != plan_key(plan_b, CPU)


def test_request_key_stable_and_blind_to_scheduling(ws):
    a, b = _reqs(ws, 1, seed0=3)[0], _reqs(ws, 1, seed0=3)[0]
    assert request_key(a, STREAM) == request_key(b, STREAM)
    for change in ({"priority": 7}, {"deadline_s": 5.0}):
        assert request_key(dataclasses.replace(a, **change), STREAM) == request_key(a, STREAM)


def test_request_key_distinct_per_result_field(ws):
    """The fields the JAX package's key hashes, the port's stream (seed,
    given blocks, given population) and the device's tag."""
    base = _reqs(ws, 1)[0]
    changes = [
        {"objective": "edp"}, {"area_constr": 151.0}, {"backend": "dense"},
        {"pop_size": POP + 1}, {"generations": GENS + 1}, {"top_k": 5},
        {"seed": 12345}, {"ws": base.ws.subset([0])},
        {"init_genomes": np.full((POP, space.N_GENES), 0.5, np.float32)},
        {"u_blocks": np.full((GENS, 10), 0.5, np.float32)},
    ]
    keys = {request_key(base, STREAM)}
    for change in changes:
        k = request_key(dataclasses.replace(base, **change), STREAM)
        assert k not in keys, f"request_key collides on {list(change)}"
        keys.add(k)
    assert request_key(base, stream_tag("cuda")) not in keys
    assert ResultCache(device="cuda").key(base) == request_key(base, stream_tag("cuda"))
    assert ResultCache(device="cpu").key(base) == request_key(base, STREAM)


def test_request_key_follows_the_model_version_and_the_grid(ws, monkeypatch):
    base = _reqs(ws, 1)[0]
    k0 = request_key(base, STREAM)
    monkeypatch.setattr(imc, "COST_MODEL_VERSION", imc.COST_MODEL_VERSION + "-next")
    assert request_key(base, STREAM) != k0
    monkeypatch.undo()
    space.configure_grid(2)
    try:
        assert request_key(base, STREAM) != k0
    finally:
        space.configure_grid(1)
    assert request_key(base, STREAM) == k0


def test_grid_token_and_cost_model_version_match_the_reference():
    assert space.grid_token() == rspace.grid_token()
    from repro.imc import COST_MODEL_VERSION as RVERSION

    assert imc.COST_MODEL_VERSION == RVERSION


def test_engine_refuses_a_cache_of_another_device():
    with pytest.raises(ValueError, match="Generator"):
        SearchEngine(device=CPU, result_cache=ResultCache(device="cuda"))


# ------------------------------------------------------------- the cache
def test_hit_equals_a_fresh_search_with_no_launch(ws, one):
    req, fresh = one
    cache = ResultCache(device=CPU)
    eng = SearchEngine(device=CPU, result_cache=cache)
    a = eng.run([req])[0]
    b = eng.run([req])[0]
    assert b is a and eng.launches == 1
    assert cache.stats.hits == 1 and cache.stats.puts == 1
    _bit_equal(a, fresh)


def test_put_refuses_partials(ws, one):
    req, fresh = one
    cache = ResultCache(device=CPU)
    assert not cache.put(req, empty_partial_result(req))
    assert not cache.put(req, dataclasses.replace(fresh, partial=True))
    assert cache.get(req) is None and cache.stats.puts == 0
    assert cache.put(req, fresh) and cache.get(req) is fresh


@pytest.mark.parametrize("pipelined", [False, True])
def test_disk_tier_serves_a_fresh_cache(tmp_path, ws, pipelined):
    req = _reqs(ws, 2, seed0=20)[1]
    res = SearchEngine(device=CPU, pipelined=pipelined).run([req])[0]
    assert (res.ga is None) == pipelined
    ResultCache(disk_dir=tmp_path, device=CPU).put(req, res)
    fresh = ResultCache(disk_dir=tmp_path, device=CPU)
    got = fresh.get(req)
    assert fresh.stats.disk_hits == 1 and req in fresh
    _bit_equal(got, res)
    assert fresh.disk_keys() == [fresh.key(req)]
    fresh.clear(disk=True)
    assert fresh.disk_keys() == [] and len(fresh) == 0


def test_encode_decode_round_trip(one):
    _, res = one
    _bit_equal(_decode(_encode(res)), res)
    thin = dataclasses.replace(res, ga=None)
    _bit_equal(_decode(_encode(thin)), thin)


def test_lru_eviction_order_and_disk_untouched(tmp_path, one):
    _, res = one
    cache = ResultCache(capacity=2, disk_dir=tmp_path, device=CPU)
    for k in ("a", "b", "c"):
        cache.put(k, res)
    assert cache.mem_keys() == ["b", "c"] and cache.stats.evictions == 1
    assert cache.get("b") is res
    assert cache.mem_keys() == ["c", "b"]
    cache.put("d", res)
    assert cache.mem_keys() == ["b", "d"]
    assert sorted(cache.disk_keys()) == ["a", "b", "c", "d"]
    assert cache.get("a") is not None and cache.stats.disk_hits == 1
    assert ResultCache(device=CPU).stats.hit_rate() == 0.0


def test_second_drain_makes_no_launch(ws):
    reqs = paper_request_mix(ws, 6, backend="table", pop_size=POP, generations=GENS)
    cache = ResultCache(device=CPU)
    svc = DSEService(engine=SearchEngine(device=CPU, result_cache=cache))
    rids0 = svc.submit_all(reqs)
    first = [svc.drain()[r] for r in rids0]
    assert svc.engine.launches == 1
    svc2 = DSEService(engine=SearchEngine(device=CPU, result_cache=cache, pipelined=True))
    rids = svc2.submit_all(reqs)
    assert svc2.pending() == 0 and svc2.engine.launches == 0
    assert svc2.stats.cache_hits == 6 and svc2.stats.cache_hit_rate() == 1.0
    for a, rid in zip(first, rids):
        _bit_equal(svc2.results[rid], a)


def test_pipelined_results_cache_and_resubmit(ws):
    reqs = _reqs(ws, 3, seed0=30)
    cache = ResultCache(device=CPU)
    eng = SearchEngine(device=CPU, result_cache=cache, pipelined=True)
    a = eng.run(reqs)
    b = eng.run(reqs)
    assert eng.launches == 1 and all(x is y for x, y in zip(a, b))
    assert all(x.ga is None for x in a)


def test_service_stats_empty_percentiles_are_none():
    st = ServiceStats()
    assert st.wait_p(50) is None and st.latency_p(99) is None
    assert st.summary()["cache_hit_rate"] == 0.0


# ------------------------------------------------------ plan keys, memo
def test_checkpoint_under_one_tech_not_resumed_under_another(ws, tmp_path):
    reqs_a = _reqs(ws, 1, seed0=5)
    reqs_b = _reqs(ws, 1, seed0=5, tech=_perturb(TECH, "adc_energy_pj"))
    pa, pb = plan_batch(reqs_a)[0], plan_batch(reqs_b)[0]
    assert plan_key(pa, CPU) != plan_key(pb, CPU)
    assert plan_key(pa, CPU) != plan_key(pa, "cuda")
    ref_b = SearchEngine(device=CPU).run(reqs_b)[0]
    SearchEngine(device=CPU, segment_gens=2, checkpoint_dir=str(tmp_path)).run(reqs_a)
    out_b = SearchEngine(device=CPU, segment_gens=2,
                         checkpoint_dir=str(tmp_path)).run(reqs_b)[0]
    _bit_equal(out_b, ref_b)


def test_tables_memo_is_a_capped_lru(monkeypatch):
    monkeypatch.setenv("REPRO_TABLES_MEMO_CAP", "2")
    pack._TABLES_MEMO.clear()
    w1, w2, w3 = (pack_workloads([(n, cnn_workload(n))])
                  for n in ("resnet18", "alexnet", "vgg16"))
    gt = space.grid_token()
    t2 = w2.tables()
    w1.tables()
    w2.tables()  # w1 becomes the oldest
    w3.tables()  # evicts w1
    assert len(pack._TABLES_MEMO) == 2
    assert (w1.fingerprint(), TECH, gt) not in pack._TABLES_MEMO
    t1 = w1.tables()  # rebuilds, evicts w2
    assert t1 is w1.tables()
    for a, b in zip(t2, w2.tables()):
        assert torch.equal(a, b)
    monkeypatch.setenv("REPRO_TABLES_MEMO_CAP", "0")
    with pytest.raises(ValueError):
        w3.tables()
    pack._TABLES_MEMO.clear()


def test_tables_match_the_reference_memo():
    names = ("resnet18", "mobilenetv3")
    r = rpack([(n, cnn_workload(n)) for n in names])
    p = convert.workload_set_from_arrays(r.names, r.feats, r.mask)
    assert p.fingerprint() == r.fingerprint()
    for a, b in zip(p.tables(), r.tables()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
