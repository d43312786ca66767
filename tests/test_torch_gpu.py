"""The port's CUDA kernels on the card: each against its plain version on
the same CUDA tensors, and the main path's launch counts.

Marked ``gpu``; run on a host with a CUDA card and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Whether a card is present is decided inside the ``cuda`` fixture, never
while the module is imported, so every test collects on every host and
skips without a card."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import ga, search, space
from repro_torch.imc.cost import DesignArrays, evaluate_designs_arrays
from repro_torch.imc.tables import WorkloadTables, build_tables_arrays
from repro_torch.kernels.ga_gen_step import ref as gref
from repro_torch.kernels.ga_gen_step.ops import ga_gen_step
from repro_torch.kernels.imc_eval import ref as iref
from repro_torch.kernels.imc_eval.ops import evaluate_designs_kernel_arrays, imc_eval_multi
from repro_torch.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro_torch.workloads.pack import pack_workloads

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ws():
    return pack_workloads([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("B,P", [(8, 40), (3, 129), (2, 1)])
def test_imc_eval_kernel_matches_plain(cuda, ws, B, P):
    g = torch.rand((B, P, space.N_GENES), generator=_gen(cuda, P), device=cuda)
    designs = torch.stack(list(space.decode(g)), dim=-1)
    feats = ws.feats[None].expand(B, -1, -1, -1).to(cuda).contiguous()
    mask = ws.mask[None].expand(B, -1, -1).to(cuda).contiguous()
    before = imc_eval_multi.launches
    k = imc_eval_multi(designs, feats, mask)
    assert imc_eval_multi.launches == before + 1
    p = iref.eval_workloads(designs, feats, mask)
    for a, b in zip(k, p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)
    assert torch.equal(k[2], p[2])  # integer demand sums are exact
    d = DesignArrays(*designs.unbind(-1))
    rk = evaluate_designs_kernel_arrays(d, feats, mask)
    rp = evaluate_designs_arrays(d, feats, mask)
    assert torch.equal(rk.fits, rp.fits) and torch.equal(rk.valid, rp.valid)


def _b2_case(dev, ws, P, subsets, seed):
    W = max(len(s) for s in subsets)
    per = []
    for s in subsets:
        sub = ws.subset(s)
        t = build_tables_arrays(sub.feats.to(dev), sub.mask.to(dev))
        per.append(WorkloadTables(*(
            torch.cat([x, x.new_zeros((W - len(s), *x.shape[1:]))]) for x in t)))
    tables = WorkloadTables(*(torch.stack(x) for x in zip(*per)))
    B = len(subsets)
    kind = torch.arange(B, device=dev) % 4
    area = torch.tensor([(150.0, 1e9, 100.0)[i % 3] for i in range(B)], device=dev)
    gen = _gen(dev, seed)
    pop = torch.rand((B, P, space.N_GENES), generator=gen, device=dev)
    scores = gref.table_scores(pop, tables, kind, area)
    u = torch.rand((3, B, ga.block_layout(P, space.N_GENES).tot), generator=gen,
                   device=dev)
    return (tables, kind, area), pop, scores, u


@pytest.mark.parametrize("P", [15, 16, 40, 257])
def test_ga_gen_step_kernel_bit_exact(cuda, ws, P):
    ctx, pop, scores, u = _b2_case(cuda, ws, P, [[0], [1, 2], [0, 1, 2, 3], [3]], P)
    ck = cp = (pop, scores)
    for g in range(3):
        before = ga_gen_step.launches
        k = ga_gen_step(ck[0], ck[1], u[g], ctx)
        assert ga_gen_step.launches == before + 1
        p = gref.ga_gen_step_ref(cp[0], cp[1], u[g], *ctx)
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        ck, cp = k[:2], p[:2]


def test_ga_gen_step_kernel_rejects_what_it_does_not_implement(cuda, ws):
    ctx, pop, scores, u = _b2_case(cuda, ws, 8, [[0, 1]], 0)
    with pytest.raises(ValueError, match="eta"):
        ga_gen_step(pop, scores, u[0], ctx, sbx_eta=2.0)
    big = 1 << 14
    ctx2, pop2, scores2, u2 = _b2_case(cuda, ws, big, [[0]], 1)
    with pytest.raises(ValueError, match="shared memory"):
        ga_gen_step(pop2, scores2, u2[0], ctx2)


@pytest.mark.parametrize("backend,counter", [("kernel", imc_eval_multi),
                                             ("table", ga_gen_step)])
def test_main_path_runs_through_kernels(cuda, ws, backend, counter):
    counter.launches = 0
    res = search.joint_search_batched([0, 1], ws, pop_size=16, generations=3,
                                      backend=backend)
    assert counter.launches > 0
    for r in res:
        assert r.ga.genomes.shape == (4, 16, space.N_GENES)
        conv = r.convergence
        assert (np.diff(conv[np.isfinite(conv)]) <= 0).all()


def test_table_and_kernel_backends_agree_on_card(cuda, ws):
    """Same seed, same initial population: the table and kernel backends
    score the same designs (to rtol 1e-5) in the first generation."""
    init = search.seed_population(0, ws, 16)
    a = search.run_search(0, ws, pop_size=16, generations=1, backend="table",
                          init_genomes=init)
    b = search.run_search(0, ws, pop_size=16, generations=1, backend="kernel",
                          init_genomes=init)
    sa, sb = a.ga.scores[0], b.ga.scores[0]
    assert np.array_equal(np.isfinite(sa), np.isfinite(sb))
    np.testing.assert_allclose(sa[np.isfinite(sa)], sb[np.isfinite(sb)], rtol=1e-5)
