"""The GA's captured generations (``core.ga.CapturePlan``, ``GRAPHS``).

On the CPU:
  * which callbacks declare a capture plan (the engine's dense and kernel
    callbacks of every tail but Pareto) and which do not (the table
    callback with its ``gen_step``, Pareto, ``split_eval`` wrappers, user
    callables, ``make_eval_fn``), and that CPU or fake CUDA populations
    never engage the graphs;
  * the kernel plan's three pieces compose to the callback's scores, bit
    for bit;
  * the cache key moves with B, the ctx's shapes, the grid and the
    variation's parameters; the cache captures on a key's second sighting,
    keeps ``cap`` keys least recently used first, and makes one entry a
    key under many threads;
  * a CPU ``run_ga_batched`` is a hand-written loop of ``plain_gen_step``.

On the card (``-m gpu``; no JAX in this file, so ``--noconftest`` runs it):
replayed generations against the eager step bit for bit (the kernel
backend at the sweep's joint and separate shapes, the dense backend, the
weighted tail, chained segments, threefry streams through the engine),
and one ``imc_eval`` launch per replayed generation.
"""
from __future__ import annotations

import sys
import threading

import pytest
import torch

from repro_torch.core import ga, space
from repro_torch.core import distributed as mdist
from repro_torch.core.engine import INDEXED, WEIGHTED, SearchEngine, _ctx_eval, make_eval_fn
from repro_torch.core.objectives import PARETO
from repro_torch.imc.tech import TECH
from repro_torch.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro_torch.workloads.pack import pack_workloads

N = space.N_GENES
KW = dict(sbx_prob=ga.SBX_PROB, sbx_eta=ga.SBX_ETA, mut_eta=ga.MUT_ETA)


@pytest.fixture(scope="module")
def ws():
    return pack_workloads([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])


def _tail_ctx(tail, B, device, g):
    if tail == INDEXED:
        kinds = torch.randint(0, 4, (B,), generator=g).to(device)
        return (kinds, torch.full((B,), 150.0, device=device))
    if tail == WEIGHTED:
        return (torch.rand((B, 3), generator=g).to(device),)
    return ()


def _inputs(ws, backend, tail, B, W, P, G, device, seed=0):
    """Seed populations (B, P, n), a (G, B, tot) stream and the callback's
    ctx: each search on the first ``W`` workloads of ``ws`` (one workload,
    a different one a search, when ``W`` is 1, as ``separate_search``)."""
    g = torch.Generator().manual_seed(seed)
    init = torch.rand((B, P, N), generator=g).to(device)
    u = torch.rand((G, B, ga.block_layout(P, N).tot), generator=g).to(device)
    if W == 1:
        feats = ws.feats[torch.arange(B) % ws.n][:, None]
        mask = ws.mask[torch.arange(B) % ws.n][:, None]
    else:
        feats = ws.feats[None, :W].expand(B, -1, -1, -1)
        mask = ws.mask[None, :W].expand(B, -1, -1)
    ctx = (feats.contiguous().to(device), mask.contiguous().to(device))
    return init, u, ctx + _tail_ctx(tail, B, device, g)


# ------------------------------------------------------------- on the CPU
PLANNED = [(b, t) for b in ("dense", "kernel") for t in (INDEXED, WEIGHTED, "ela", "edp")]
UNPLANNED = [("table", INDEXED), ("table", WEIGHTED), ("dense", PARETO), ("kernel", PARETO)]


@pytest.mark.parametrize("backend,tail", PLANNED)
def test_dense_and_kernel_callbacks_declare_a_plan(backend, tail):
    fn = _ctx_eval(TECH, backend, tail, 150.0)
    plan = fn.capture_plan
    assert isinstance(plan, ga.CapturePlan) and not hasattr(fn, "gen_step")
    # the kernel backend splits around B1's operator; dense is one graph
    assert (plan.call is not None) == (backend == "kernel")


@pytest.mark.parametrize("backend,tail", UNPLANNED)
def test_table_and_pareto_callbacks_declare_none(backend, tail):
    fn = _ctx_eval(TECH, backend, tail, 150.0)
    assert getattr(fn, "capture_plan", None) is None
    assert hasattr(fn, "gen_step") == (backend == "table" and tail == INDEXED)


@pytest.mark.parametrize("kind", ["split_eval", "user", "make_eval_fn"])
def test_wrappers_and_user_callables_declare_none(kind, ws):
    base = _ctx_eval(TECH, "kernel")
    fn = {"split_eval": lambda: mdist.split_eval(base, mdist.MeshLayout(("data",), (2,))),
          "user": lambda: (lambda genomes, ctx: base(genomes, ctx)),
          "make_eval_fn": lambda: make_eval_fn(ws, "ela", 150.0, backend="dense",
                                               device="cpu")}[kind]()
    assert fn is not base and getattr(fn, "capture_plan", None) is None


@pytest.mark.parametrize("backend,tail", PLANNED[:2] + PLANNED[4:6])
def test_cpu_and_fake_populations_never_engage(backend, tail, ws):
    from repro_torch.launch.dryrun import fake_mode

    fn = _ctx_eval(TECH, backend, tail, 150.0)
    assert not ga.captures(fn, torch.zeros((2, 4, N)))
    with fake_mode():
        fake = torch.zeros((2, 4, N), device="cuda")
        assert fake.device.type == "cuda" and not ga.captures(fn, fake)
    ga.GRAPHS.clear()
    init, u, ctx = _inputs(ws, backend, tail, 2, 2, 8, 3, "cpu")
    for _ in range(3):
        ga.run_ga_batched(fn, pop_size=8, generations=3, init_genomes=init, ctx=ctx,
                          u_blocks=u)
    assert ga.GRAPHS.keys() == []


@pytest.mark.parametrize("tail", [INDEXED, WEIGHTED, "ela"])
@pytest.mark.parametrize("W", [1, 4])
def test_kernel_plan_composes_to_the_callback(tail, W, ws):
    fn = _ctx_eval(TECH, "kernel", tail, 150.0)
    plan = fn.capture_plan
    genomes, _, ctx = _inputs(ws, "kernel", tail, 3, W, 16, 1, "cpu", seed=W)
    mid = plan.head(genomes, ctx)
    out = plan.call(mid, ctx)
    assert tuple(out.shape) == (3, 3, W, 16)
    got = plan.tail(genomes, mid, out, ctx)
    assert torch.equal(got, fn(genomes, ctx))


def _key(fn, pop, ctx, **kw):
    return ga.graph_key(fn, pop, ctx, **{**KW, **kw})


@pytest.mark.parametrize("change", ["B", "ctx_shape", "ctx_dtype", "grid", "sbx_prob",
                                    "sbx_eta", "mut_eta", "callback"])
def test_cache_key_moves_with_what_a_graph_depends_on(change, ws):
    fn = _ctx_eval(TECH, "kernel")
    pop, _, ctx = _inputs(ws, "kernel", INDEXED, 4, 4, 8, 1, "cpu")
    base = _key(fn, pop, ctx)
    assert _key(fn, pop.clone(), tuple(t.clone() for t in ctx)) == base
    if change == "B":
        other = _key(fn, pop[:2], tuple(t[:2] for t in ctx))
    elif change == "ctx_shape":
        other = _key(fn, pop, (ctx[0][:, :1], ctx[1][:, :1]) + ctx[2:])
    elif change == "ctx_dtype":
        other = _key(fn, pop, ctx[:3] + (ctx[3].double(),))
    elif change == "grid":
        d0 = space.GRID_DENSITY
        space.configure_grid(d0 + 1)
        try:
            other = _key(fn, pop, ctx)
        finally:
            space.configure_grid(d0)
        assert _key(fn, pop, ctx) == base
    elif change == "callback":
        other = _key(_ctx_eval(TECH, "kernel", WEIGHTED, 150.0), pop, ctx)
    else:
        other = _key(fn, pop, ctx, **{change: KW[change] / 2})
    assert other != base


def test_cache_captures_on_the_second_sighting_and_evicts_the_oldest():
    cache = ga._GraphCache(3)
    made = []

    def make(k):
        return lambda: made.append(k) or f"entry {k}"

    assert cache.sight("a", make("a")) is None  # first: eager
    assert cache.sight("a", make("a")) == "entry a"  # second: made
    assert cache.sight("a", make("a")) == "entry a" and made == ["a"]
    for k in "bc":
        assert cache.sight(k, make(k)) is None
    assert cache.keys() == ["a", "b", "c"]
    assert cache.sight("a", make("a")) == "entry a"  # a is the most recent now
    assert cache.sight("d", make("d")) is None  # evicts b, the least recent
    assert cache.keys() == ["c", "a", "d"]
    assert cache.sight("b", make("b")) is None  # b starts over: eager again
    assert cache.keys() == ["a", "d", "b"]
    assert made == ["a"]
    assert len(ga.GRAPHS.keys()) <= ga.GRAPH_CACHE_KEYS == ga.GRAPHS.cap


def test_cache_makes_one_entry_a_key_under_many_threads():
    cache = ga._GraphCache(4)
    made, lock = [], threading.Lock()
    got = [[] for _ in range(16)]

    def make(k):
        def f():
            with lock:
                made.append(k)
            return object()
        return f

    def work(i):
        for j in range(400):
            k = j % 3
            e = cache.sight(k, make(k))
            if e is not None:
                got[i].append((k, e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert sorted(made) == [0, 1, 2]  # one entry a key: no lost update
    entries = {}
    for k, e in (x for g in got for x in g):
        assert entries.setdefault(k, e) is e


@pytest.mark.parametrize("backend,tail", [("dense", INDEXED), ("kernel", INDEXED),
                                          ("kernel", WEIGHTED), ("dense", "ela")])
def test_cpu_run_is_a_loop_of_plain_gen_step(backend, tail, ws):
    fn = _ctx_eval(TECH, backend, tail, 150.0)
    init, u, ctx = _inputs(ws, backend, tail, 2, 4, 10, 3, "cpu", seed=7)
    res = ga.run_ga_batched(fn, pop_size=10, generations=3, init_genomes=init, ctx=ctx,
                            u_blocks=u)
    pop, scores = init.clone(), fn(init, ctx)
    hg, hs = [pop], [scores]
    for g in range(3):
        pop, scores, children, child_scores = ga.plain_gen_step(pop, scores, u[g], fn, ctx)
        hg.append(children)
        hs.append(child_scores)
    assert torch.equal(res.genomes, torch.stack(hg, dim=1))
    assert torch.equal(res.scores, torch.stack(hs, dim=1))


# ------------------------------------------------------------- on the card
@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


def _eager(monkeypatch):
    """The eager step: no callback captures."""
    monkeypatch.setattr(ga, "captures", lambda eval_fn, pop: False)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


GPU_CASES = {  # name -> (backend, tail, B, W)
    "kernel_joint": ("kernel", INDEXED, 8, 4),
    "kernel_separate": ("kernel", INDEXED, 4, 1),
    "kernel_weighted": ("kernel", WEIGHTED, 8, 4),
    "dense_joint": ("dense", INDEXED, 8, 4),
    "dense_static": ("dense", "ela", 4, 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(GPU_CASES))
def test_replayed_generations_are_the_eager_bits(case, cuda, ws, monkeypatch):
    """Three runs of one shape (eager, capture, replay) against the eager
    step: every generation's population, scores and children, and one
    ``imc_eval`` launch a generation on the kernel backend."""
    from repro_torch.kernels.imc_eval.ops import imc_eval_multi

    backend, tail, B, W = GPU_CASES[case]
    fn = _ctx_eval(TECH, backend, tail, 150.0)
    P, G = 40, 10
    init, u, ctx = _inputs(ws, backend, tail, B, W, P, G, cuda, seed=B * 10 + W)
    kw = dict(pop_size=P, generations=G, init_genomes=init, ctx=ctx, u_blocks=u)
    with monkeypatch.context() as m:
        _eager(m)
        want = ga.run_ga_batched(fn, **kw)
    ga.GRAPHS.clear()
    for sighting in range(3):
        before = imc_eval_multi.launches
        got = ga.run_ga_batched(fn, **kw)
        torch.cuda.synchronize()
        assert _equal(got, want), (case, sighting)
        if backend == "kernel":  # the seed evaluation and one a generation
            assert imc_eval_multi.launches - before == G + 1
        entry = ga.GRAPHS._entries[ga.graph_key(fn, init, ctx, **KW)]
        assert (entry is not None and entry.ready) == (sighting > 0)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [(3, 3, 4), (1, 9), (5, 5)])
def test_chained_segments_replay_the_eager_bits(splits, cuda, ws, monkeypatch):
    fn = _ctx_eval(TECH, "kernel")
    P, G = 40, sum(splits)
    init, u, ctx = _inputs(ws, "kernel", INDEXED, 8, 4, P, G, cuda, seed=11)

    def chained():
        state = ga.init_ga_state_batched(fn, init, u, ctx)
        hg, hs = [], []
        for k in splits:
            state, (g, s) = ga.run_ga_batched_segment(state, fn, generations=k,
                                                      total_generations=G, ctx=ctx)
            hg.append(g)
            hs.append(s)
        return state.genomes, state.scores, torch.cat(hg, 1), torch.cat(hs, 1)

    with monkeypatch.context() as m:
        _eager(m)
        want = chained()
    ga.GRAPHS.clear()
    for _ in range(2):
        assert _equal(chained(), want)


@pytest.mark.gpu
def test_threefry_sweep_replays_the_eager_bits(cuda, ws, monkeypatch):
    """The Fig. 2 sweep's two launches on threefry streams, kernel backend
    (a joint plan of eight seeds, a separate plan of four workloads):
    every result equals the eager step's."""
    from repro_torch.core.search import joint_search_batched, separate_search

    def run():
        kw = dict(backend="kernel", prng="threefry", device=cuda, pop_size=40,
                  generations=10, engine=SearchEngine(device=cuda, prng="threefry"))
        res = joint_search_batched(list(range(8)), ws, **kw)
        res += list(separate_search(8, ws, **kw).values())
        return [(r.top_scores, r.top_genomes, r.convergence) for r in res]

    with monkeypatch.context() as m:
        _eager(m)
        want = run()
    ga.GRAPHS.clear()
    for _ in range(3):
        for got, exp in zip(run(), want, strict=True):
            for a, b in zip(got, exp):
                assert (a == b).all()
