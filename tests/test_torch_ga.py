"""Port parity: the GA generation step, survival and drivers against the
JAX package.

Both sides are fed the same uniform block (drawn by ``jax.random`` and
handed to the port) and the same tables.  The reference is compared as a
compiled program (``jax.jit``), as its own kernel-parity tests do; XLA
contracts multiply-adds into FMAs there, so genes are held at atol 1e-6
with equal decoded grid cells, scores at rtol 1e-5, and the selection
logic (survival order, parents) exactly."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ga as rga
from repro.core import space as rspace
from repro.core.engine import INDEXED
from repro.core.engine import _ctx_eval as r_ctx_eval
from repro.imc import tables as rtables
from repro.imc.tech import TECH as RTECH
from repro.kernels.ga_gen_step import ga_gen_step_pallas
from repro.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert
from repro_torch.core import ga, space
from repro_torch.core.engine import _ctx_eval
from repro_torch.imc import tables
from repro_torch.kernels.ga_gen_step import ref as gref
from repro_torch.kernels.ga_gen_step.ops import ga_gen_step


@pytest.fixture(scope="module")
def ws_ref():
    return rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])


@pytest.fixture(scope="module")
def tabs(ws_ref):
    tr = rtables.build_tables_arrays(ws_ref.feats, ws_ref.mask)
    return tr, convert.tables_from_arrays(tr, device="cpu")


def _batched(t):
    return tables.WorkloadTables(*(x[None] for x in t))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x)).to(dtype)


def _same_cells(a, b):
    np.testing.assert_array_equal(space.decode_indices_np(np.asarray(a)),
                                  space.decode_indices_np(np.asarray(b)))


def _close_scores(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=1e-5, atol=0)


def _ref_step(pop_size, kind, area, tr):
    eval_fn = r_ctx_eval(INDEXED, 0.0, RTECH, "table")
    ctx = (tr, jnp.int32(kind), jnp.float32(area))
    gen = rga._make_gen_step(eval_fn, ctx, pop_size, rspace.N_GENES, rga.SBX_PROB,
                             rga.SBX_ETA, rga.MUT_ETA, fused=True)
    return eval_fn, ctx, jax.jit(gen)


def _port_ctx(t, kind, area):
    return (_batched(t), torch.tensor([kind]), torch.tensor([area], dtype=torch.float32))


def test_block_layout_matches_reference():
    lay = ga.block_layout(40, 9)
    assert lay.tot == 1180
    for P in (1, 8, 15, 16, 40, 41):
        n_pairs = (P + 1) // 2
        assert ga.block_layout(P, 9).tot == \
            2 * (2 * n_pairs) + n_pairs * 9 + n_pairs + n_pairs * 9 + 2 * P * 9


@pytest.mark.parametrize("pop,kind,area", [(8, 0, 150.0), (15, 1, 1e9),
                                           (16, 2, 100.0), (24, 3, 150.0)])
def test_gen_step_matches_reference_lax(tabs, pop, kind, area):
    """One generation, fed the same u and tables, against the reference's
    compiled lax generation step."""
    tr, t = tabs
    eval_fn, ctx, gen = _ref_step(pop, kind, area, tr)
    popg = rspace.random_genomes(jax.random.PRNGKey(pop), pop)
    scores = eval_fn(popg, ctx)
    k = jax.random.fold_in(jax.random.PRNGKey(3), pop)
    u = jax.random.uniform(k, (ga.block_layout(pop, 9).tot,))
    (p_r, s_r), (c_r, cs_r) = gen((popg, scores), k)

    port_scores = gref.table_scores(_t(popg)[None], _batched(t), *_port_ctx(t, kind, area)[1:])
    _close_scores(port_scores[0], scores)
    new_pop, new_scores, children, child_scores = ga_gen_step(
        _t(popg)[None], _t(scores)[None], _t(u)[None], _port_ctx(t, kind, area))
    np.testing.assert_allclose(children[0].numpy(), np.asarray(c_r), atol=1e-6, rtol=0)
    _same_cells(children[0], c_r)
    _close_scores(child_scores[0], cs_r)
    _same_cells(new_pop[0], p_r)
    np.testing.assert_allclose(new_pop[0].numpy(), np.asarray(p_r), atol=1e-6, rtol=0)
    _close_scores(new_scores[0], s_r)


@pytest.mark.parametrize("pop", [8, 15])
def test_gen_step_matches_reference_pallas_interpret(tabs, pop):
    """Against the reference's whole-generation Pallas kernel (interpret
    mode), fed the same u and tables."""
    tr, t = tabs
    eval_fn, ctx, _ = _ref_step(pop, 0, 150.0, tr)
    popg = rspace.random_genomes(jax.random.PRNGKey(7), pop)
    scores = eval_fn(popg, ctx)
    u = jax.random.uniform(jax.random.PRNGKey(11), (ga.block_layout(pop, 9).tot,))
    p_r, s_r, c_r, cs_r = ga_gen_step_pallas(
        popg, scores, u, tr, jnp.int32(0), jnp.float32(150.0), tech=RTECH,
        sbx_prob=rga.SBX_PROB, sbx_eta=rga.SBX_ETA, mut_eta=rga.MUT_ETA,
        interpret=True)
    new_pop, new_scores, children, child_scores = ga_gen_step(
        _t(popg)[None], _t(scores)[None], _t(u)[None], _port_ctx(t, 0, 150.0))
    np.testing.assert_allclose(children[0].numpy(), np.asarray(c_r), atol=1e-6, rtol=0)
    _same_cells(children[0], c_r)
    _close_scores(child_scores[0], cs_r)
    _same_cells(new_pop[0], p_r)
    _close_scores(new_scores[0], s_r)


def test_chained_generations_track_reference(tabs):
    tr, t = tabs
    P = 12
    eval_fn, ctx, gen = _ref_step(P, 0, 150.0, tr)
    popg = rspace.random_genomes(jax.random.PRNGKey(1), P)
    carry_r = (popg, eval_fn(popg, ctx))
    pop, scores = _t(popg)[None], _t(carry_r[1])[None]
    pctx = _port_ctx(t, 0, 150.0)
    for g in range(4):
        k = jax.random.fold_in(jax.random.PRNGKey(9), g)
        u = _t(jax.random.uniform(k, (ga.block_layout(P, 9).tot,)))[None]
        carry_r, _ = gen(carry_r, k)
        pop, scores, _, _ = ga_gen_step(pop, scores, u, pctx)
        _same_cells(pop[0], carry_r[0])
        _close_scores(scores[0], carry_r[1])


def _survival_cases():
    rng = np.random.default_rng(0)
    inf, nan = np.inf, np.nan
    return {
        "dups": np.array([3.0, 1.0, 3.0, 1.0, 2.0, 1.0], np.float32),
        "signed_zero": np.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0, 1e-30], np.float32),
        "inf": np.array([inf, 2.0, inf, -inf, 2.0, inf, 0.5, inf], np.float32),
        "nan": np.array([1.0, nan, 0.0, -nan, inf, nan, -2.0, 3.0, nan], np.float32),
        "odd": rng.standard_normal(31).astype(np.float32),
        "all_inf": np.full(10, inf, np.float32),
        "random": np.where(rng.random(80) < 0.4, inf,
                           rng.random(80)).astype(np.float32),
    }


@pytest.mark.parametrize("case", sorted(_survival_cases()))
def test_survival_order_matches_reference(case):
    x = _survival_cases()[case]
    k = (len(x) + 1) // 2
    ours = ga.survivor_indices(torch.from_numpy(x)[None], k)[0].numpy()
    theirs = np.asarray(rga._survivor_indices(jnp.asarray(x), k))
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(
        ga.order_keys(torch.from_numpy(x)).numpy(), np.asarray(rga._fold_bits(jnp.asarray(x))))
    if not np.isnan(x).any():
        # zero signs tie: compare against a stable argsort with -0.0 -> 0.0
        np.testing.assert_array_equal(ours, np.argsort(x + 0.0, kind="stable")[:k])


def test_survive_odd_population_truncates():
    rng = np.random.default_rng(1)
    pop = torch.from_numpy(rng.random((2, 7, 9), dtype=np.float32))
    ch = torch.from_numpy(rng.random((2, 7, 9), dtype=np.float32))
    s = torch.from_numpy(rng.random((2, 7)).astype(np.float32))
    cs = torch.from_numpy(np.where(rng.random((2, 7)) < 0.5, np.inf,
                                   rng.random((2, 7))).astype(np.float32))
    new_pop, new_s = ga.survive(pop, s, ch, cs)
    assert new_pop.shape == (2, 7, 9) and new_s.shape == (2, 7)
    for b in range(2):
        alls = np.concatenate([s[b].numpy(), cs[b].numpy()])
        order = np.argsort(alls, kind="stable")[:7]
        np.testing.assert_array_equal(new_s[b].numpy(), alls[order])
        allg = np.concatenate([pop[b].numpy(), ch[b].numpy()])
        np.testing.assert_array_equal(new_pop[b].numpy(), allg[order])


def test_run_ga_matches_reference_run_ga(tabs):
    """A whole GA run through the drivers (no engine), the reference's
    per-generation blocks replayed into the port."""
    tr, t = tabs
    P, G = 12, 4
    eval_fn, ctx, _ = _ref_step(P, 0, 150.0, tr)
    init = rspace.random_genomes(jax.random.PRNGKey(5), P)
    key = jax.random.PRNGKey(6)
    res_r = rga.run_ga(key, eval_fn, pop_size=P, generations=G,
                       init_genomes=jnp.array(init), ctx=ctx)
    keys = jax.random.split(key, G)
    tot = ga.block_layout(P, 9).tot
    U = np.stack([np.asarray(jax.random.uniform(keys[g], (tot,))) for g in range(G)])
    res = ga.run_ga(_ctx_eval(convert.tech_from_dict(RTECH._asdict()), "table"),
                    pop_size=P, generations=G, init_genomes=_t(init),
                    ctx=(t, torch.tensor(0), torch.tensor(150.0)), u_blocks=_t(U))
    assert res.genomes.shape == (G + 1, P, 9) and res.scores.shape == (G + 1, P)
    _same_cells(res.genomes.reshape(-1, 9), np.asarray(res_r.genomes).reshape(-1, 9))
    _close_scores(res.scores, res_r.scores)
    _close_scores(res.best_score, res_r.best_score)


def test_run_ga_batched_matches_sequential(tabs):
    """Slots over different workload subsets and objectives: each slot of
    the batched run equals its own single run, bit for bit, with given
    blocks and with per-slot generators."""
    _, t = tabs
    subsets = [[0], [1, 2], [0, 1, 2, 3]]
    W = 4
    per = []
    for s in subsets:
        sub = tables.WorkloadTables(*(x[s] for x in t))
        per.append(tables.WorkloadTables(*(
            torch.cat([x, x.new_zeros((W - len(s), *x.shape[1:]))]) for x in sub)))
    tb = tables.WorkloadTables(*(torch.stack(x) for x in zip(*per)))
    kinds, areas = torch.tensor([0, 1, 3]), torch.tensor([150.0, 1e9, 150.0])
    P, G = 10, 3
    init = torch.from_numpy(np.random.default_rng(2).random((3, P, 9), dtype=np.float32))
    ev = _ctx_eval(convert.tech_from_dict(RTECH._asdict()), "table")

    def gens():
        return [torch.Generator().manual_seed(100 + i) for i in range(3)]

    for kw_b, kw_1 in (
        (dict(u_blocks=torch.rand((G, 3, ga.block_layout(P, 9).tot))), None),
        (dict(generators=gens()), dict(generators=gens())),
    ):
        rb = ga.run_ga_batched(ev, pop_size=P, generations=G, init_genomes=init,
                               ctx=(tb, kinds, areas), **kw_b)
        for i in range(3):
            extra = (dict(u_blocks=kw_b["u_blocks"][:, i]) if kw_1 is None
                     else dict(generator=kw_1["generators"][i]))
            r1 = ga.run_ga(ev, pop_size=P, generations=G, init_genomes=init[i],
                           ctx=(tables.WorkloadTables(*(x[i] for x in tb)),
                                kinds[i], areas[i]), **extra)
            for f in ga.GAResult._fields:
                assert torch.equal(getattr(rb, f)[i], getattr(r1, f)), f


def test_run_ga_does_not_modify_init(tabs):
    _, t = tabs
    ev = _ctx_eval(convert.tech_from_dict(RTECH._asdict()), "dense")
    init = torch.rand((6, 9), generator=torch.Generator().manual_seed(0))
    keep = init.clone()
    ws = rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS[:2]])
    ctx = (_t(ws.feats), _t(ws.mask, torch.bool), torch.tensor(0), torch.tensor(150.0))
    ga.run_ga(ev, pop_size=6, generations=2, init_genomes=init, ctx=ctx,
              generator=torch.Generator().manual_seed(1))
    assert torch.equal(init, keep)


def test_table_eval_fn_carries_kernel_step_and_cpu_runs_plain(tabs):
    _, t = tabs
    assert getattr(_ctx_eval(convert.tech_from_dict(RTECH._asdict()), "table"),
                   "gen_step", None) is not None
    assert getattr(_ctx_eval(convert.tech_from_dict(RTECH._asdict()), "dense"),
                   "gen_step", None) is None
    P = 8
    pop = torch.rand((1, P, 9), generator=torch.Generator().manual_seed(3))
    ctx = _port_ctx(t, 0, 150.0)
    scores = gref.table_scores(pop, *ctx)
    u = torch.rand((1, ga.block_layout(P, 9).tot), generator=torch.Generator().manual_seed(4))
    before = ga_gen_step.launches
    out_k = ga_gen_step(pop, scores, u, ctx)
    out_p = gref.ga_gen_step_ref(pop, scores, u, *ctx)
    assert ga_gen_step.launches == before  # CPU tensors: plain version, no launch
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
