"""Port parity: the dense cost model, the V/f validity mask, and the
imc_eval kernel's plain version against the JAX package (its ``jnp``
path and its Pallas kernel in interpret mode).

Float results are held at rtol 1e-5: XLA contracts multiply-adds into
FMAs and sums in another order, so the two frameworks differ by a few
ulps.  Integer-valued results (crossbar demand, fits) and the validity
verdicts are held exactly."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import space as rspace
from repro.imc import cost as rcost
from repro.kernels.imc_eval import ref as rref
from repro.kernels.imc_eval.kernel import imc_eval_pallas_multi
from repro.kernels.imc_eval.ops import evaluate_designs_kernel
from repro.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert
from repro_torch.core import space
from repro_torch.core.objectives import OBJECTIVES, make_objective
from repro_torch.imc import cost
from repro_torch.imc.tech import TECH
from repro_torch.kernels.imc_eval import ref
from repro_torch.kernels.imc_eval.ops import evaluate_designs_kernel_arrays, imc_eval_multi

RTOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    r = rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])
    return r, convert.workload_set_from_arrays(r.names, r.feats, r.mask)


def _genomes(n, seed):
    return np.random.default_rng(seed).random((n, space.N_GENES), dtype=np.float32)


def _both_designs(g):
    return space.decode(torch.from_numpy(g)), rspace.decode(jnp.asarray(g))


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=0)


def test_vt_mask_matches_reference_on_every_cell():
    """All 160 (v_op, t_cycle_ns) cells, including the float32 boundary
    cell (0.9 V, 1.0 ns): t_min rounds to 1.0000001 there, so the
    reference calls the nominal design invalid."""
    V, T = len(space.SPACE["v_op"]), len(space.SPACE["t_cycle_ns"])
    vi, ti = np.meshgrid(np.arange(V), np.arange(T), indexing="ij")
    idx = np.zeros((V * T, space.N_GENES), np.int32)
    idx[:, space.FIELDS.index("v_op")] = vi.reshape(-1)
    idx[:, space.FIELDS.index("t_cycle_ns")] = ti.reshape(-1)
    ref_valid = np.asarray(rcost.design_valid(
        rspace.designs_from_indices(jnp.asarray(idx)))).reshape(V, T)
    mask = cost.valid_vt_mask(TECH).numpy()
    assert mask.shape == (V, T) == (20, 8)
    np.testing.assert_array_equal(mask, ref_valid)
    v9 = int(np.argmin(np.abs(space.SPACE["v_op"] - 0.9)))
    t1 = int(np.argmin(np.abs(space.SPACE["t_cycle_ns"] - 1.0)))
    assert not mask[v9, t1], "the (0.9 V, 1.0 ns) boundary cell is invalid"
    d = space.designs_from_indices(torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_array_equal(cost.design_valid(d, TECH).numpy().reshape(V, T),
                                  ref_valid)


def test_design_valid_off_grid_uses_formula():
    v = torch.tensor([0.9, 0.8123, 1.05], dtype=torch.float32)
    t = torch.tensor([1.0, 0.9, 0.5], dtype=torch.float32)
    d = space.decode(torch.full((3, space.N_GENES), 0.5))._replace(v_op=v, t_cycle_ns=t)
    dr = rspace.decode(jnp.full((3, space.N_GENES), 0.5))._replace(
        v_op=jnp.asarray(v.numpy()), t_cycle_ns=jnp.asarray(t.numpy()))
    np.testing.assert_array_equal(cost.design_valid(d).numpy(),
                                  np.asarray(rcost.design_valid(dr)))


def test_area_matches_reference():
    d, dr = _both_designs(_genomes(512, 0))
    _close(cost.area_mm2(d), rcost.area_mm2(dr))


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_cost_matches_reference(pair, seed):
    ws_r, ws = pair
    d, dr = _both_designs(_genomes(300, seed))
    r = cost.evaluate_designs(d, ws)
    rr = rcost.evaluate_designs(dr, ws_r)
    for f in ("energy_pj", "latency_ns", "area_mm2", "util"):
        _close(getattr(r, f), getattr(rr, f))
    np.testing.assert_array_equal(r.fits.numpy(), np.asarray(rr.fits))
    np.testing.assert_array_equal(r.valid.numpy(), np.asarray(rr.valid))


def test_dense_cost_batched_matches_unbatched(pair):
    _, ws = pair
    g = torch.from_numpy(_genomes(120, 2).reshape(3, 40, space.N_GENES))
    feats = ws.feats[None].expand(3, -1, -1, -1)
    mask = ws.mask[None].expand(3, -1, -1)
    rb = cost.evaluate_designs_arrays(space.decode(g), feats, mask)
    for b in range(3):
        r1 = cost.evaluate_designs_arrays(space.decode(g[b]), ws.feats, ws.mask)
        for f in r1._fields:
            assert torch.equal(getattr(rb, f)[b], getattr(r1, f)), f


@pytest.mark.parametrize("kind", OBJECTIVES)
def test_objectives_match_reference(pair, kind):
    from repro.core.objectives import make_objective as rmake

    ws_r, ws = pair
    d, dr = _both_designs(_genomes(256, 3))
    for area in (50.0, 150.0, 1e9):
        s = make_objective(kind, area)(cost.evaluate_designs(d, ws)).numpy()
        sr = np.asarray(rmake(kind, area)(rcost.evaluate_designs(dr, ws_r)))
        np.testing.assert_array_equal(np.isfinite(s), np.isfinite(sr))
        fin = np.isfinite(s)
        _close(s[fin], sr[fin])


def test_imc_eval_plain_matches_reference_oracle(pair):
    """The kernel's plain version against the reference's
    ``eval_one_workload`` for every paper CNN, batched over searches."""
    ws_r, ws = pair
    g = _genomes(130, 4)
    d = np.array(jnp.stack(list(rspace.decode(jnp.asarray(g))), axis=1))
    designs = torch.from_numpy(d)[None].expand(2, -1, -1)
    e, l, x = ref.eval_workloads(designs, ws.feats[None].expand(2, -1, -1, -1),
                                 ws.mask[None].expand(2, -1, -1))
    assert e.shape == (2, ws.n, 130)
    for w in range(ws.n):
        er, lr, xr = rref.eval_one_workload(jnp.asarray(d), ws_r.feats[w], ws_r.mask[w])
        for b in range(2):
            _close(e[b, w], er)
            _close(l[b, w], lr)
            np.testing.assert_array_equal(x[b, w].numpy(), np.asarray(xr))


@pytest.mark.parametrize("P,L", [(1, 1), (7, 3), (129, 9), (130, 65), (300, 13)])
def test_imc_eval_padding_edges_vs_pallas(P, L):
    """P off the 128-design tile and L off the 8-layer tile, as the
    reference's own padding-edge test: the plain version against the
    Pallas kernel (interpret mode) and the reference oracle."""
    key = jax.random.PRNGKey(0)
    g = rspace.random_genomes(key, P)
    d = jnp.stack(list(rspace.decode(g)), axis=1)
    feats = jnp.abs(jax.random.normal(key, (L, 6))) * 100 + 1
    mask = jnp.ones((L,), bool)
    e_p, l_p, x_p = imc_eval_pallas_multi(d, feats[None], mask[None], interpret=True)
    e_r, l_r, x_r = rref.eval_one_workload(d, feats, mask)
    e, l, x = ref.eval_one_workload(torch.from_numpy(np.asarray(d)),
                                    torch.from_numpy(np.asarray(feats)),
                                    torch.from_numpy(np.asarray(mask)))
    for a, b, c in ((e, e_p[0], e_r), (l, l_p[0], l_r), (x, x_p[0], x_r)):
        _close(a, b, rtol=2e-5)
        _close(a, c, rtol=2e-5)


def test_imc_eval_multi_ragged_masks_vs_pallas():
    key = jax.random.PRNGKey(1)
    P, W, L = 70, 3, 13
    g = rspace.random_genomes(key, P)
    d = jnp.stack(list(rspace.decode(g)), axis=1)
    feats = jnp.abs(jax.random.normal(key, (W, L, 6))) * 100 + 1
    mask = jnp.stack([jnp.arange(L) < n for n in (13, 5, 8)])
    e_p, l_p, x_p = imc_eval_pallas_multi(d, feats, mask, interpret=True)
    e, l, x = imc_eval_multi(torch.from_numpy(np.asarray(d))[None],
                             torch.from_numpy(np.asarray(feats))[None],
                             torch.from_numpy(np.asarray(mask))[None])
    assert e.shape == (1, W, P)
    _close(e[0], e_p, rtol=2e-5)
    _close(l[0], l_p, rtol=2e-5)
    _close(x[0], x_p, rtol=2e-5)  # random G: demand is not integer here


def test_kernel_eval_result_matches_reference_pallas(pair):
    """``backend="kernel"``'s EvalResult (plain layer sums on the CPU)
    against the reference's Pallas-backed EvalResult in interpret mode."""
    ws_r, ws = pair
    d, dr = _both_designs(_genomes(130, 5))
    r = evaluate_designs_kernel_arrays(d, ws.feats, ws.mask)
    rr = evaluate_designs_kernel(dr, ws_r, backend="pallas", interpret=True)
    for f in ("energy_pj", "latency_ns", "area_mm2", "util"):
        _close(getattr(r, f), getattr(rr, f))
    np.testing.assert_array_equal(r.fits.numpy(), np.asarray(rr.fits))
    np.testing.assert_array_equal(r.valid.numpy(), np.asarray(rr.valid))
    rd = cost.evaluate_designs(d, ws)
    for f in ("energy_pj", "latency_ns"):
        _close(getattr(r, f), getattr(rd, f))


def test_imc_eval_cpu_dispatch_counts_no_launch(pair):
    _, ws = pair
    d = torch.stack(list(space.decode(torch.from_numpy(_genomes(8, 6)))), dim=-1)
    before = imc_eval_multi.launches
    imc_eval_multi(d[None], ws.feats[None], ws.mask[None])
    assert imc_eval_multi.launches == before


def test_evaluate_one_requires_cuda_unless_cpu(pair):
    _, ws = pair
    design = {f: float(space.SPACE[f][0]) for f in space.FIELDS}
    r = cost.evaluate_one(design, ws, device="cpu")
    assert r.energy_pj.shape == (1, ws.n)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cost.evaluate_one(design, ws)
