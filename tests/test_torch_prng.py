"""The port's threefry streams (``repro_torch.core.prng``) against
``jax.random``, and whole runs on them against the JAX package.

The primitives are held bit for bit (``gumbel`` within 1e-6 relative to
max(|g|, 1): the two frameworks' float32 ``log`` differ by an ulp).  The
runs get no fed draws (no ``u_blocks``, no ``init_genomes``): the port
draws from the same seed or key as the reference, so the seeded
generation-0 population is bit-exact and the top designs are equal, with
scores and convergence at rtol 1e-5 (``test_torch_search.py``'s
tolerances).  Runs stay at P <= 16 and G <= 4: 40x10 runs part after a few
generations on one-ulp score differences (ROADMAP C, "Long runs")."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as rengine
from repro.core import search as rsearch
from repro.launch import search as rlaunch
from repro.serve import dse as rdse
from repro.serve import steps as rsteps
from repro.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert
from repro_torch.core import engine, ga, prng, search, space
from repro_torch.core.engine import SearchEngine, SearchRequest
from repro_torch.launch import search as launch
from repro_torch.serve import dse, steps
from repro_torch.serve.cache import ResultCache, request_key

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")
TF = dict(device="cpu", prng="threefry")
P, G = 16, 4
SEEDS = (0, 1, 7, 1000, 2**31 - 1, 2**32 + 3, -1)


@pytest.fixture(scope="module")
def pair():
    r = rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])
    return r, convert.workload_set_from_arrays(r.names, r.feats, r.mask)


def _bits(x) -> np.ndarray:
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32)


def _same_result(res, res_r):
    assert res.workload_names == res_r.workload_names
    assert res.objective == res_r.objective
    assert res.top_designs == res_r.top_designs
    np.testing.assert_array_equal(space.decode_indices_np(res.top_genomes),
                                  space.decode_indices_np(np.asarray(res_r.top_genomes)))
    np.testing.assert_allclose(res.top_scores, res_r.top_scores, rtol=1e-5, atol=0)
    a, b = np.asarray(res.convergence), np.asarray(res_r.convergence)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=1e-5, atol=0)
    assert res.valid == res_r.valid and res.generations == res_r.generations


def _same_gen0(res, res_r):
    np.testing.assert_array_equal(_bits(res.ga.genomes[0]), _bits(res_r.ga.genomes[0]))


# ------------------------------------------------------------- primitives
@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    k = prng.PRNGKey(seed)
    np.testing.assert_array_equal(prng.key_data(k), np.asarray(jax.random.PRNGKey(seed)))
    assert torch.equal(prng.as_key(np.asarray(jax.random.PRNGKey(seed))), k)


@pytest.mark.parametrize("bad", [[-1, 3], [0.5, 1.0], [1, 2, 3], [0, 2**32]])
def test_as_key_refuses_malformed_words(bad):
    with pytest.raises(ValueError, match="key"):
        prng.as_key(bad)


@pytest.mark.parametrize("n", [1, 2, 3, 10, 64])
def test_split_matches_jax_nested_twice(n):
    kj = jax.random.PRNGKey(42)
    once = jax.random.split(kj, n)
    twice = jax.vmap(lambda k: jax.random.split(k, n))(once)
    kt = prng.PRNGKey(42)
    np.testing.assert_array_equal(prng.key_data(prng.split(kt, n)), np.asarray(once))
    np.testing.assert_array_equal(prng.key_data(prng.split(prng.split(kt, n), n)),
                                  np.asarray(twice))


@pytest.mark.parametrize("shape", [(), (7,), (40, 11), (3, 5, 7), (1180,)])
def test_uniform_matches_jax(shape):
    for s in (0, 3):
        got = prng.uniform(prng.PRNGKey(s), shape)
        want = jax.random.uniform(jax.random.PRNGKey(s), shape)
        assert tuple(got.shape) == shape and got.dtype == torch.float32
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_uniform_range_matches_jax():
    got = prng.uniform(prng.PRNGKey(5), (257,), minval=-2.0, maxval=3.5)
    want = jax.random.uniform(jax.random.PRNGKey(5), (257,), minval=-2.0, maxval=3.5)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_batch_of_keys_matches_vmap():
    keys = jax.random.split(jax.random.PRNGKey(9), 6).reshape(2, 3, 2)
    want = jax.vmap(jax.vmap(lambda k: jax.random.uniform(k, (4, 9))))(keys)
    got = prng.uniform(prng.as_key(np.asarray(keys)), (4, 9))
    assert tuple(got.shape) == (2, 3, 4, 9)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    want_split = jax.vmap(jax.vmap(lambda k: jax.random.split(k, 5)))(keys)
    np.testing.assert_array_equal(prng.key_data(prng.split(prng.as_key(np.asarray(keys)), 5)),
                                  np.asarray(want_split))


def test_gumbel_within_1e6():
    got = prng.gumbel(prng.PRNGKey(11), (64, 1000)).numpy()
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(11), (64, 1000)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_threefry_calls_no_library_rng(monkeypatch):
    """The draws never touch torch's generators."""
    def boom(*a, **k):
        raise AssertionError("a library RNG was called")

    for name in ("rand", "randn", "randint", "rand_like", "randperm"):
        monkeypatch.setattr(torch, name, boom)
    prng.uniform(prng.split(prng.PRNGKey(0), 4), (9,))
    prng.gumbel(prng.PRNGKey(1), (5,))


def test_chip_script_constants_match_jax():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    k0 = jax.random.PRNGKey(0)
    assert smoke.THREEFRY_SPLIT0 == np.asarray(jax.random.split(k0, 2)).tolist()
    assert smoke.THREEFRY_SPLIT0_64_LAST == np.asarray(jax.random.split(k0, 64))[-1].tolist()
    for shape, (head, tail) in smoke.THREEFRY_UNIFORM0.items():
        want = [int(w) for w in _bits(jax.random.uniform(k0, shape)).reshape(-1)]
        assert want[: len(head)] == head and want[-len(tail):] == tail
    assert smoke.THREEFRY_SPLIT0 == prng.key_data(prng.split(prng.PRNGKey(0))).tolist()


# ------------------------------------------------------------- whole runs
@pytest.fixture(scope="module")
def ref_runs(pair):
    """The JAX package's run_search from PRNGKey(0) per backend."""
    ws_r, _ = pair
    return {b: rsearch.run_search(jax.random.PRNGKey(0), ws_r, pop_size=P, generations=G,
                                  backend=b)
            for b in ("table", "jnp", "pallas")}


@pytest.mark.parametrize("backend,ref_backend", [("table", "table"), ("dense", "jnp"),
                                                 ("kernel", "pallas")])
def test_run_search_replays_reference_from_the_seed(pair, ref_runs, backend, ref_backend):
    _, ws = pair
    res = search.run_search(0, ws, pop_size=P, generations=G, backend=backend, **TF)
    _same_result(res, ref_runs[ref_backend])
    # the same key given explicitly draws the same
    k = search.run_search(99, ws, pop_size=P, generations=G, backend=backend,
                          key=np.asarray(jax.random.PRNGKey(0)), **TF)
    _same_result(k, ref_runs[ref_backend])


@pytest.mark.parametrize("backend,ref_backend", [("table", "table"), ("dense", "jnp")])
def test_generation0_population_equals_the_reference_engine(pair, ref_runs, backend,
                                                            ref_backend):
    _, ws = pair
    res = search.run_search(0, ws, pop_size=P, generations=G, backend=backend, **TF)
    _same_gen0(res, ref_runs[ref_backend])
    ws_r, _ = pair
    # seed_population(key=...) is the reference's seed_population(key, ...)
    k = jax.random.PRNGKey(5)
    pop = engine.seed_population(0, ws, P, key=np.asarray(k), **CPU)
    np.testing.assert_array_equal(_bits(pop), _bits(rengine.seed_population(k, ws_r, P)))


def test_separate_search_replays_reference(pair):
    ws_r, ws = pair
    sep_r = rsearch.separate_search(jax.random.PRNGKey(1), ws_r, pop_size=P,
                                    generations=G, backend="table")
    sep = search.separate_search(1, ws, pop_size=P, generations=G, backend="table", **TF)
    assert list(sep) == list(sep_r)
    for name in ws.names:
        _same_result(sep[name], sep_r[name])
        _same_gen0(sep[name], sep_r[name])
    one = search.separate_search(1, ws, pop_size=P, generations=G, backend="table",
                                 batched=False, **TF)
    for name in ws.names:
        np.testing.assert_array_equal(one[name].ga.genomes, sep[name].ga.genomes)


def test_joint_search_batched_replays_reference(pair):
    ws_r, ws = pair
    kw = dict(pop_size=12, generations=3, backend="dense")
    ref = rsearch.joint_search_batched(
        jnp.stack([jax.random.PRNGKey(s) for s in range(3)]), ws_r,
        **{**kw, "backend": "jnp"})
    got = search.joint_search_batched([0, 1, 2], ws, **kw, **TF)
    for a, b in zip(got, ref):
        _same_result(a, b)
        _same_gen0(a, b)


def test_engine_mixed_requests_replay_reference(pair):
    """test_torch_search.py's heterogeneous table plan, with keys in place
    of fed draws."""
    ws_r, ws = pair
    specs = [([0], "ela", 150.0), ([1, 2], "edp", 1e9), ([0, 1, 2, 3], "e", 100.0),
             ([3], "l", 150.0)]
    reqs_r, reqs = [], []
    for i, (s, obj, area) in enumerate(specs):
        key = jax.random.PRNGKey(20 + i)
        kw = dict(objective=obj, area_constr=area, backend="table", pop_size=12,
                  generations=3)
        reqs_r.append(rengine.SearchRequest(ws=ws_r.subset(s), key=key, **kw))
        reqs.append(engine.SearchRequest(ws=ws.subset(s), seed=i, key=np.asarray(key), **kw))
    out_r = rengine.SearchEngine().run(reqs_r)
    eng = SearchEngine(**TF)
    out = eng.run(reqs)
    assert eng.launches == 1
    for a, b in zip(out, out_r):
        _same_result(a, b)
        _same_gen0(a, b)


def test_direct_seeded_table_run_replays_reference(pair):
    ws_r, ws = pair
    req_r = rengine.SearchRequest(ws=ws_r, seed=3, backend="table", pop_size=P,
                                  generations=G)
    ref = rengine.SearchEngine(direct_seed=True).run([req_r])[0]
    got = SearchEngine(direct_seed=True, **TF).run([SearchRequest(
        ws=ws, seed=3, backend="table", pop_size=P, generations=G)])[0]
    _same_result(got, ref)
    _same_gen0(got, ref)


def test_weighted_run_replays_reference(pair):
    ws_r, ws = pair
    w = (0.5, 2.0, 1.5)
    kw = dict(obj_weights=w, area_constr=1e9, backend="table", pop_size=12, generations=3)
    ref = rengine.SearchEngine().run([rengine.SearchRequest(ws=ws_r, seed=8, **kw)])[0]
    got = SearchEngine(**TF).run([SearchRequest(ws=ws, seed=8, **kw)])[0]
    _same_result(got, ref)
    _same_gen0(got, ref)


def test_pareto_run_replays_reference(pair):
    ws_r, ws = pair
    kw = dict(objective="pareto", pareto_k=5, pop_size=12, generations=3, backend="table")
    ref = rsearch.run_search(jax.random.PRNGKey(4), ws_r, **kw)
    got = search.run_search(4, ws, **kw, **TF)
    _same_result(got, ref)
    np.testing.assert_allclose(got.objective_vectors, np.asarray(ref.objective_vectors),
                               rtol=1e-5, atol=0)
    _same_gen0(got, ref)


def test_service_drain_replays_reference(pair):
    """An 8-request table drain through DSEService from the requests' seeds."""
    ws_r, ws = pair
    reqs_r = rdse.paper_request_mix(ws_r, 8, pop_size=12, generations=3)
    svc_r = rdse.DSEService()
    rids = svc_r.submit_all(reqs_r)
    res_r = svc_r.drain()
    svc = dse.DSEService(**TF)
    assert svc.engine.prng == "threefry"
    rids_p = svc.submit_all(dse.paper_request_mix(ws, 8, pop_size=12, generations=3))
    res = svc.drain()
    for a, b in zip(rids_p, rids):
        _same_result(res[a], res_r[b])


def test_cli_json_replays_the_reference_cli(tmp_path):
    flags = ["--pop", "16", "--gens", "3", "--seeds", "2", "--separate", "--backend", "table"]
    assert rlaunch.main(flags + ["--out", str(tmp_path / "ref.json")]) == 0
    assert launch.main(flags + ["--device", "cpu", "--prng", "threefry",
                                "--out", str(tmp_path / "port.json")]) == 0
    ref = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert [e["seed"] for e in got] == [e["seed"] for e in ref] == [0, 1]
    for a, b in zip(got, ref):
        assert a["best_design"] == b["best_design"]
        np.testing.assert_allclose(a["joint_top10"], b["joint_top10"], rtol=1e-5)
        np.testing.assert_allclose(a["convergence"], b["convergence"], rtol=1e-5)
        assert set(a["separate"]) == set(b["separate"])
        for name, s in a["separate"].items():
            r = b["separate"][name]
            assert (s["own_best"] is None) == (r["own_best"] is None)
            if s["own_best"] is not None:
                np.testing.assert_allclose(s["own_best"], r["own_best"], rtol=1e-5)
            assert s["failed_frac_on_all"] == r["failed_frac_on_all"]


# --------------------------------------------------- streams kept apart
def test_streams_have_their_own_tags_and_keys(pair):
    _, ws = pair
    assert engine.stream_tag("cpu") == "repro_torch seed streams v1, torch.Generator(cpu)"
    assert engine.stream_tag("cpu", "threefry") != engine.stream_tag("cpu")
    assert engine.stream_tag("cpu", "threefry") != engine.stream_tag("cuda", "threefry")
    assert SearchEngine(**TF).stream == engine.stream_tag("cpu", "threefry")
    req = SearchRequest(ws=ws, seed=3, backend="table", pop_size=8, generations=2)
    plan = engine.plan_batch([req])[0]
    assert engine.plan_key(plan, "cpu") != engine.plan_key(plan, "cpu", "threefry")
    assert request_key(req, engine.stream_tag("cpu")) != \
        request_key(req, engine.stream_tag("cpu", "threefry"))
    keyed = SearchRequest(ws=ws, seed=3, backend="table", pop_size=8, generations=2,
                          key=np.asarray(jax.random.PRNGKey(4)))
    tag = engine.stream_tag("cpu", "threefry")
    assert request_key(keyed, tag) != request_key(req, tag)
    with pytest.raises(ValueError, match="prng"):
        engine.stream_tag("cpu", "philox")


def test_a_key_on_the_torch_streams_raises(pair):
    _, ws = pair
    req = SearchRequest(ws=ws, backend="table", pop_size=8, generations=2,
                        key=np.asarray(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="threefry"):
        SearchEngine(**CPU).run([req])
    with pytest.raises(ValueError, match="threefry"):
        dse.DSEService(**CPU).submit(req)
    with pytest.raises(ValueError, match="threefry"):
        search.run_search(0, ws, pop_size=8, generations=2, key=np.asarray(req.key), **CPU)
    with pytest.raises(ValueError, match="threefry"):
        search.separate_search(0, ws, pop_size=8, generations=2, key=req.key, **CPU)


def test_engine_and_cache_of_another_stream_raise(pair):
    _, ws = pair
    with pytest.raises(ValueError, match="draws"):
        SearchEngine(result_cache=ResultCache(**CPU), **TF)
    with pytest.raises(ValueError, match="draws"):
        SearchEngine(result_cache=ResultCache(**TF), **CPU)
    with pytest.raises(ValueError, match="prng"):
        search.run_search(0, ws, pop_size=8, generations=2, engine=SearchEngine(**CPU),
                          **TF)
    with pytest.raises(ValueError, match="prng"):
        dse.DSEService(engine=SearchEngine(**CPU), prng="threefry")


def test_threefry_cache_round_trip_is_keyed_by_stream(pair):
    _, ws = pair
    cache = ResultCache(**TF)
    eng = SearchEngine(result_cache=cache, **TF)
    req = SearchRequest(ws=ws, seed=2, backend="table", pop_size=8, generations=2)
    first = eng.run([req])[0]
    assert eng.launches == 1 and cache.get(req) is not None
    again = eng.run([req])[0]
    assert eng.launches == 1
    np.testing.assert_array_equal(first.top_scores, again.top_scores)


def test_given_blocks_and_population_still_override(pair):
    """``u_blocks`` / ``init_genomes`` win over the threefry draws, slot by
    slot, as on the torch streams."""
    _, ws = pair
    base = dict(ws=ws, backend="table", pop_size=8, generations=2)
    eng = SearchEngine(**TF)
    a, b = eng.run([SearchRequest(seed=1, **base), SearchRequest(seed=2, **base)])
    tot = ga.block_layout(8, space.N_GENES).tot
    u = np.asarray(jax.random.uniform(jax.random.PRNGKey(77), (2, tot)))
    c, d = eng.run([SearchRequest(seed=1, u_blocks=u, init_genomes=b.ga.genomes[0], **base),
                    SearchRequest(seed=2, **base)])
    np.testing.assert_array_equal(c.ga.genomes[0], b.ga.genomes[0])
    np.testing.assert_array_equal(d.ga.genomes, b.ga.genomes)
    assert not np.array_equal(c.ga.genomes[1:], a.ga.genomes[1:])


# ------------------------------------------------------------- sampling
def test_temperature_sample_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 3, 512)).astype(np.float32)
    for seed, temp in ((0, 1.0), (3, 0.7)):
        kj = jax.random.PRNGKey(seed)
        want = np.asarray(rsteps.temperature_sample(jnp.asarray(logits), kj, temp))
        got = steps.temperature_sample(torch.from_numpy(logits), np.asarray(kj), temp).numpy()
        assert got.shape == want.shape == (6, 1) and got.dtype == np.int32
        noisy = logits[:, -1] / temp + np.asarray(jax.random.gumbel(kj, (6, 512)))
        top2 = np.sort(noisy, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 1e-4
        assert clear.sum() >= 5
        np.testing.assert_array_equal(got[clear], want[clear])


# ------------------------------------------------------------- example
def test_quickstart_prints_the_threefry_joint_best(pair, capsys):
    """At pop 8 and 2 generations no design PRNGKey(0) draws meets 150 mm^2
    (the example then says so), so the check lifts the area constraint."""
    from repro_torch.examples import quickstart

    _, ws = pair
    assert quickstart.main(["--device", "cpu", "--pop", "8", "--gens", "2",
                            "--area", "1e9"]) == 0
    out = capsys.readouterr().out
    ref = search.run_search(0, ws, pop_size=8, generations=2, area_constr=1e9, **TF)
    assert f"best generalized design (score {ref.top_scores[0]:.6g}):" in out
    for k, v in ref.top_designs[0].items():
        assert f"   {k:14s} = {v}\n" in out
    assert out.count("of top designs fail on the full workload set") == ws.n
