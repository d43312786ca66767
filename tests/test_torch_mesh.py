"""The port's search stack on a mesh of ranks (``launch/mesh.py``,
``core/distributed.py``, ``mesh=`` on the engine, drivers, service and CLI)
against its meshless runs and the JAX package.

* The layout rules (``batch_axes`` / ``batch_spec`` / ``shape_spec``) and the
  mesh constructors' clamping equal the JAX package's on ``AbstractMesh``
  layouts and faked device counts, with one-name tuples normalised (jax
  0.9.0's ``PartitionSpec`` stores ``("search",)`` as ``"search"``).
* Multi-rank runs: worlds of 4 (a 2x2 mesh) and 2 (2x1 and 1x2) on gloo,
  spawned with a ``FileStore`` under ``tmp_path`` (no TCP port, so parallel
  test workers cannot collide), every group with a timeout, every join with
  a deadline that kills the ranks.  Each rank runs every case of ``CASES``
  and each result is held bit for bit against the same case run meshless in
  this process; on threefry the meshless run is also held against the JAX
  package's, at ``tests/test_torch_prng.py``'s tolerances.
* A world of one in this process gives the meshless bits, and the
  refusals (``separate_search(mesh=, batched=False)``, an engine on
  another device than the mesh's, the train launcher's ``--data 2``).

Sizes: pop <= 16, 3-4 generations, the paper's four CNNs."""
from __future__ import annotations

import datetime
import pickle
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import distributed as mdist
from repro_torch.core import engine, search, space
from repro_torch.core.engine import SearchEngine, SearchRequest
from repro_torch.launch import mesh as lmesh
from repro_torch.serve import dse
from repro_torch.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro_torch.workloads.pack import pack_workloads

CPU = dict(device="cpu")
P, G = 16, 3
WORLDS = {4: ((2, 2),), 2: ((2, 1), (1, 2))}
GROUP_TIMEOUT_S = 60.0
JOIN_DEADLINE_S = 240.0


def _ws():
    return pack_workloads([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])


# ------------------------------------------------------------------ the cases
def _digest(results):
    """Every array of a list of ``SearchResult``s, for bitwise comparison."""
    out = []
    for r in results:
        out.append((r.workload_names, r.objective, r.valid, r.partial, r.generations))
        out.append(np.asarray(r.top_scores))
        out.append(np.asarray(r.top_genomes))
        out.append(np.asarray(r.convergence))
        out.append(r.top_designs)
        if r.objective_vectors is not None:
            out.append(np.asarray(r.objective_vectors))
        if r.ga is not None:
            out.extend(np.asarray(f) for f in r.ga)
    return out


def _batched(mesh, tmp, *, backend, B=4, pop=P, **kw):
    ws = _ws()
    return search.joint_search_batched(list(range(B)), ws, pop_size=pop, generations=G,
                                       backend=backend, mesh=mesh, **CPU, **kw)


class _Stop(Exception):
    pass


def _resume(mesh, tmp):
    """A segmented plan interrupted after its second checkpoint, then run
    again by a fresh engine, which resumes from the lead's checkpoint."""
    ws = _ws()
    reqs = dse.paper_request_mix(ws, 4, backend="table", pop_size=P, generations=4)
    plan = engine.plan_batch(reqs)[0]
    kw = dict(segment_gens=1, checkpoint_dir=str(tmp / "ck"), mesh=mesh, **CPU)

    def stop(i, snap):
        if snap.generations >= 2:
            raise _Stop

    with pytest.raises(_Stop):
        SearchEngine(**kw).execute(plan, on_progress=stop)
    ck = tmp / "ck" / engine.plan_key(plan, "cpu")
    lead = mdist.is_lead(mesh)
    steps = sorted(engine.store.committed_steps(ck)) if lead else None
    res = SearchEngine(**kw).execute(plan)
    seen = (steps, engine.store.committed_steps(ck) if lead else None)
    if mesh is not None:  # the lead's disk, as every rank's engine left it
        seen = mdist.broadcast_object(mesh, seen)
    return list(seen) + _digest(res)


def _drain(mesh, tmp, *, backend="table", n=8, prng="torch", pop=P, gens=G):
    ws = _ws()
    svc = dse.DSEService(mesh=mesh, max_slots=4, prng=prng, **CPU)
    rids = svc.submit_all(dse.paper_request_mix(ws, n, backend=backend, pop_size=pop,
                                                generations=gens))
    out = svc.drain()
    return [rids] + _digest([out[r] for r in rids])


def _async_drain(mesh, tmp):
    ws = _ws()
    with dse.AsyncDSEService(mesh=mesh, max_slots=4, pipelined=True, **CPU) as svc:
        futs = svc.submit_all(dse.paper_request_mix(ws, 8, backend="kernel",
                                                    pop_size=P, generations=G))
        res = [f.result(timeout=120) for f in futs]
    return _digest(res)


def _direct_seed(mesh, tmp):
    ws = _ws()
    reqs = dse.paper_request_mix(ws, 4, backend="table", pop_size=P, generations=G)
    return _digest(SearchEngine(direct_seed=True, mesh=mesh, **CPU).run(reqs))


def _seed_pools(mesh, tmp):
    ws = _ws()
    gens = [engine._slot_generators(s, "cpu")[0] for s in range(4)]
    feats = ws.feats[None].expand(4, *ws.feats.shape)
    mask = ws.mask[None].expand(4, *ws.mask.shape)
    return [engine.seed_population_batched(gens, feats, mask, P, mesh=mesh)]


def _eval_fns(mesh, tmp):
    """The split eval callbacks on this rank's rows, gathered: the engine's
    indexed dense callback and the single-search ``sharded_eval_fn``."""
    ws = _ws()
    g = torch.from_numpy(np.random.default_rng(0).random((4, P, space.N_GENES),
                                                         dtype=np.float32))
    ctx = (ws.feats[None].expand(4, *ws.feats.shape), ws.mask[None].expand(4, *ws.mask.shape),
           torch.tensor([0, 1, 2, 3]), torch.full((4,), 150.0))
    if mesh is None:
        return [engine._ctx_eval(engine.TECH, "dense")(g, ctx),
                engine._ctx_eval(engine.TECH, "dense", "ela", 150.0)(
                    g[:1], tuple(t[:1] for t in ctx))[0]]
    ev = mdist.sharded_batched_eval_fn(mesh, "indexed", 0.0, backend="dense")
    local = ev(mdist.place_batched(mesh, g), tuple(mdist.place_batched(mesh, t) for t in ctx))
    single = mdist.sharded_eval_fn(mesh, ws, "ela", 150.0)(g[0])
    return [mdist.gather_rows(mesh, local, 4), single]


def _run_ga(mesh, tmp):
    """``sharded_run_ga_batched`` on fed draws against ``run_ga_batched``."""
    ws = _ws()
    rng = np.random.default_rng(1)
    init = torch.from_numpy(rng.random((4, P, space.N_GENES), dtype=np.float32))
    tot = engine.block_layout(P, space.N_GENES).tot
    u = torch.from_numpy(rng.random((G, 4, tot), dtype=np.float32))
    ctx = (ws.feats[None].expand(4, *ws.feats.shape), ws.mask[None].expand(4, *ws.mask.shape),
           torch.tensor([0, 1, 2, 3]), torch.full((4,), 150.0))
    ev = engine._ctx_eval(engine.TECH, "dense")
    kw = dict(pop_size=P, generations=G, init_genomes=init, ctx=ctx, u_blocks=u)
    if mesh is None:
        return list(engine.run_ga_batched(ev, **kw))
    return list(mdist.sharded_run_ga_batched(mesh, ev, **kw))


CASES = {
    "dense": lambda m, t: _digest(_batched(m, t, backend="dense")),
    "kernel": lambda m, t: _digest(_batched(m, t, backend="kernel")),
    "table": lambda m, t: _digest(_batched(m, t, backend="table")),
    "ragged_odd_dense": lambda m, t: _digest(_batched(m, t, backend="dense", B=3, pop=15)),
    "ragged_odd_table": lambda m, t: _digest(_batched(m, t, backend="table", B=3, pop=15)),
    "pipelined_kernel": lambda m, t: _digest(search.joint_search_batched(
        [0, 1, 2, 3], _ws(), pop_size=P, generations=G, backend="kernel", mesh=m,
        engine=SearchEngine(pipelined=True, mesh=m, **CPU), **CPU)),
    "separate": lambda m, t: _digest(search.separate_search(
        5, _ws(), pop_size=P, generations=G, mesh=m, **CPU).values()),
    "pareto": lambda m, t: _digest(_batched(m, t, backend="dense", objective="pareto",
                                            pareto_k=5)),
    "weighted": lambda m, t: _digest(_batched(m, t, backend="table",
                                              obj_weights=[(1, 1, 1), (1, 2, 0)] * 2)),
    "direct_seed": _direct_seed,
    "seed_pools": _seed_pools,
    "eval_fns": _eval_fns,
    "run_ga": _run_ga,
    "drain": _drain,
    "async_drain": _async_drain,
    "resume": _resume,
    "tf_dense": lambda m, t: _digest(_batched(m, t, backend="dense", prng="threefry")),
    "tf_ragged_odd_table": lambda m, t: _digest(_batched(m, t, backend="table", B=3, pop=15,
                                                         prng="threefry")),
    "tf_separate": lambda m, t: _digest(search.separate_search(
        1, _ws(), pop_size=P, generations=G, backend="table", prng="threefry", mesh=m,
        **CPU).values()),
    "tf_drain": lambda m, t: _drain(m, t, prng="threefry", pop=12),
}


def _run_cases(mesh, tmp: Path) -> dict:
    out = {}
    for name, case in CASES.items():
        mdist.STATS.reset()
        sub = tmp / name
        sub.mkdir(parents=True, exist_ok=True)
        out[name] = (case(mesh, sub), mdist.STATS.calls, mdist.STATS.bytes)
    return out


# ------------------------------------------------------------- the ranks
def _rank_main(rank: int, world: int, store: str, out: str, shapes) -> None:
    """One rank of a spawned gloo world: every case on every mesh shape."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        got = {}
        for shape in shapes:
            mesh = lmesh.make_search_mesh(*shape, device_type="cpu",
                                          timeout_s=GROUP_TIMEOUT_S)
            assert lmesh.mesh_axis_sizes(mesh) == {"search": shape[0], "data": shape[1]}
            tmp = Path(out) / f"{shape[0]}x{shape[1]}"  # shared, as a CLI's dirs
            got[shape] = _run_cases(mesh, tmp)
        with open(f"{out}/rank{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def _spawn(world: int, shapes, tmp: Path) -> list:
    """Run ``_rank_main`` on ``world`` spawned ranks; fail (and kill them)
    past the deadline or if one fails."""
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp / "store"), str(tmp), shapes),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_DEADLINE_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"world of {world} ranks passed its "
                                     f"{JOIN_DEADLINE_S} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{(S, P): [per-rank case outputs]} of every spawned mesh."""
    got = {}
    for world, shapes in WORLDS.items():
        ranks = _spawn(world, shapes, tmp_path_factory.mktemp(f"world{world}"))
        for shape in shapes:
            got[shape] = [r[shape] for r in ranks]
    return got


@pytest.fixture(scope="module")
def meshless(tmp_path_factory):
    return _run_cases(None, tmp_path_factory.mktemp("meshless"))


def _bits_equal(a, b, where):
    if isinstance(a, (list, tuple)) and not isinstance(a, str):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _bits_equal(x, y, f"{where}[{i}]")
        return
    if isinstance(a, torch.Tensor):
        a, b = a.numpy(), b.numpy()
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        if a.dtype.kind == "f":
            a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    assert a == b, where


MESHES = [s for shapes in WORLDS.values() for s in shapes]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_run_equals_the_meshless_bits(worlds, meshless, shape, case):
    ref = meshless[case][0]
    for rank, got in enumerate(worlds[shape]):
        out, calls, nbytes = got[case]
        _bits_equal(out, ref, f"{shape} rank {rank} {case}")
        # every run on a mesh of two or more ranks talks (at least the
        # lead's broadcast of its cache lookups or plans), but the seeder
        # alone runs replicated along data
        silent = case == "seed_pools" and shape[0] == 1
        assert (calls == nbytes == 0) if silent else (calls > 0 and nbytes > 0)


def test_resume_case_resumed_from_a_checkpoint(meshless, worlds):
    steps, after = meshless["resume"][0][:2]
    assert steps == [1, 2] and after == []
    for shape in MESHES:
        for got in worlds[shape]:
            assert got["resume"][0][:2] == [[1, 2], []]


def test_split_runs_gather_along_both_axes(worlds):
    """On 2x2 the dense B=4, P=16 run splits rows and populations: each
    rank gathers the population scores of every generation and the rows of
    the history, far more than the broadcasts alone."""
    for got in worlds[(2, 2)]:
        _, calls, nbytes = got["dense"]
        # (G + 1) population gathers of (2, 16) float32 scores, then the
        # history's rows: (4, G+1, 16, 9) genomes and (4, G+1, 16) scores
        assert calls >= G + 1 + 4
        assert nbytes >= 4 * (G + 1) * P * (space.N_GENES + 1) * 4


# ----------------------------------------------- threefry against the JAX package
@pytest.fixture(scope="module")
def reference_runs():
    import jax
    import jax.numpy as jnp

    from repro.core import search as rsearch
    from repro.serve import dse as rdse
    from repro.workloads.pack import pack_workloads as rpack

    ws_r = rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])
    keys = lambda n: jnp.stack([jax.random.PRNGKey(s) for s in range(n)])  # noqa: E731
    out = {
        "tf_dense": rsearch.joint_search_batched(keys(4), ws_r, pop_size=P, generations=G,
                                                 backend="jnp"),
        "tf_ragged_odd_table": rsearch.joint_search_batched(
            keys(3), ws_r, pop_size=15, generations=G, backend="table"),
        "tf_separate": list(rsearch.separate_search(
            jax.random.PRNGKey(1), ws_r, pop_size=P, generations=G,
            backend="table").values()),
    }
    svc = rdse.DSEService(max_slots=4)
    rids = svc.submit_all(rdse.paper_request_mix(ws_r, 8, backend="table", pop_size=12,
                                                 generations=G))
    res = svc.drain()
    out["tf_drain"] = [res[r] for r in rids]
    return out


@pytest.mark.parametrize("case", ["tf_dense", "tf_ragged_odd_table", "tf_separate",
                                  "tf_drain"])
def test_threefry_mesh_runs_replay_the_reference(meshless, reference_runs, case):
    """The meshless bits the mesh runs equal, against the JAX package's
    meshless run: top designs equal, scores within rtol 1e-5."""
    digest = meshless[case][0]
    if case == "tf_drain":
        digest = digest[1:]
    ref = reference_runs[case]
    per = len(digest) // len(ref)
    for i, r in enumerate(ref):
        d = digest[i * per:(i + 1) * per]
        head, top_s, top_g, conv, designs = d[:5]
        assert head[0] == tuple(r.workload_names) and head[1] == r.objective
        assert designs == r.top_designs
        np.testing.assert_array_equal(space.decode_indices_np(top_g),
                                      space.decode_indices_np(np.asarray(r.top_genomes)))
        np.testing.assert_allclose(top_s, np.asarray(r.top_scores), rtol=1e-5, atol=0)
        c = np.asarray(r.convergence)
        np.testing.assert_array_equal(np.isfinite(conv), np.isfinite(c))
        np.testing.assert_allclose(conv[np.isfinite(conv)], c[np.isfinite(c)], rtol=1e-5)


# ------------------------------------------------------ layout rules vs JAX
def _norm(spec):
    return tuple(None if p is None else ((p,) if isinstance(p, str) else tuple(p))
                 for p in spec)


LAYOUTS = [((1, 1), ("search", "data")), ((2, 1), ("search", "data")),
           ((1, 2), ("search", "data")), ((2, 2), ("search", "data")),
           ((4, 2), ("search", "data")), ((2, 4), ("search", "data")),
           ((8, 1), ("search", "data")), ((3, 1), ("search", "data")),
           ((2, 2), ("data", "model")), ((4,), ("model",)), ((2, 3), ("search", "model")),
           ((2, 2, 2), ("pod", "data", "model")), ((2, 2, 2), ("search", "data", "model"))]
SHAPES = [(8, 40, 9), (6, 41, 9), (3, 16, 9), (4, 15), (12,), (64, 40, 9, 3), (1, 1)]


@pytest.mark.parametrize("sizes,names", LAYOUTS, ids=lambda v: "x".join(map(str, v)))
def test_layout_rules_equal_the_reference(sizes, names):
    from jax.sharding import AbstractMesh

    from repro.core import distributed as rdist

    ref = AbstractMesh(sizes, names)
    mine = mdist.MeshLayout(names, sizes)
    assert mdist.batch_axes(mine) == rdist.batch_axes(ref)
    assert mdist.pop_axes(mine) == rdist.pop_axes(ref)
    for ndim in (1, 2, 3, 4):
        for pop_dim in (None, 0, 1, 2, 5):
            assert mdist.batch_spec(mine, ndim, pop_dim) == _norm(
                rdist.batch_spec(ref, ndim, pop_dim))
    for shape in SHAPES:
        for pop_dim in (None, 1):
            assert mdist.shape_spec(mine, shape, pop_dim) == _norm(
                rdist.shape_spec(ref, shape, pop_dim))


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_constructors_clamp_as_the_reference(n, monkeypatch):
    from repro.launch import mesh as rmesh

    monkeypatch.setattr(rmesh.jax, "devices", lambda: [object()] * n)
    monkeypatch.setattr(rmesh, "Mesh", lambda devs, axes: (tuple(devs.shape), tuple(axes)))
    req = [None, 1, 2, 3, 4, 8, 16]
    for s in req:
        for p in req:
            want = rmesh.make_search_mesh(s, p)
            assert ((lmesh.fit_search_mesh(n, s, p)), ("search", "data")) == want
    for s in (1, 2, 4, 8):
        for d in (1, 2, 3, 8):
            for m in (1, 2, 4):
                assert lmesh.fit_test_mesh(n, d, m, s) == rmesh.make_test_mesh(d, m, s)


# ------------------------------------------------------ a world of one, here
@pytest.fixture
def world_of_one():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_world_of_one_gives_the_meshless_bits(world_of_one, meshless, tmp_path):
    mesh = lmesh.make_search_mesh(8, 2, device_type="cpu")  # clamps to 1x1
    assert lmesh.describe(mesh) == "search=1xdata=1"
    for case in ("dense", "table", "pareto", "drain", "resume", "tf_dense"):
        mdist.STATS.reset()
        sub = tmp_path / case
        sub.mkdir()
        _bits_equal(CASES[case](mesh, sub), meshless[case][0], case)
        assert mdist.STATS.calls == 0  # nothing to talk to
    assert lmesh.mesh_axis_sizes(lmesh.make_test_mesh(2, 2, 4, device_type="cpu")) == {
        "search": 1, "data": 1, "model": 1}
    with pytest.raises(ValueError, match="product"):
        lmesh.make_production_mesh(device_type="cpu")


def test_refusals(world_of_one):
    ws = _ws()
    mesh = lmesh.make_search_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="batched=True"):
        search.separate_search(0, ws, pop_size=P, generations=G, mesh=mesh,
                               batched=False, **CPU)
    card_mesh = lmesh.make_search_mesh(device_type="cuda")  # gloo groups, a card's name
    with pytest.raises(ValueError, match="cannot run"):
        SearchEngine(mesh=card_mesh, **CPU)
    eng = SearchEngine(**CPU)
    req = SearchRequest(ws=ws, pop_size=P, generations=G)
    with pytest.raises(ValueError, match="cannot run"):
        eng.run([req], mesh=card_mesh)
    with pytest.raises(ValueError, match="another mesh"):
        dse.DSEService(engine=eng, mesh=mesh)
    from repro_torch.launch import train

    # the LM launcher no longer refuses a mesh: --data 2 clamps to this world
    assert train.main(["--device", "cpu", "--data", "2", "--d-model", "64", "--layers", "2",
                       "--seq", "32", "--batch", "2", "--steps", "1"]) == 0
    assert dist.is_initialized()  # the fixture's world, left as it was


def test_cli_search_mesh_in_a_world_of_one(world_of_one, tmp_path, capsys):
    """``--search-mesh`` clamps to the world and writes the meshless run's
    results."""
    from repro_torch.launch import search as launch

    args = ["--device", "cpu", "--pop", str(P), "--gens", str(G), "--seeds", "2"]
    assert launch.main(args + ["--search-mesh", "4x2", "--out", str(tmp_path / "m.json")]) == 0
    assert "mesh: search=1xdata=1 (1 ranks, gloo)" in capsys.readouterr().out
    assert launch.main(args + ["--out", str(tmp_path / "n.json")]) == 0
    import json

    a, b = (json.load(open(tmp_path / f)) for f in ("m.json", "n.json"))
    for e in a + b:
        e.pop("wall_s")
    assert a == b
    assert launch.main(args + ["--search-mesh", "2x1", "--serve", "4",
                               "--out", str(tmp_path / "s.json")]) == 0
    assert len(json.load(open(tmp_path / "s.json"))) == 4


def test_process_groups_carry_their_timeout(world_of_one):
    mesh = lmesh.make_search_mesh(device_type="cpu", timeout_s=7.0)
    for name in ("search", "data"):
        group = mesh.get_group(name)
        backend = group._get_backend(torch.device("cpu"))
        assert backend.options._timeout == datetime.timedelta(seconds=7.0)
