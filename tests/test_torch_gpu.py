"""The port's CUDA kernels on the card: each against its plain version on
the same CUDA tensors, and the main paths' launch counts (the DSE search
and the LM serving engine); and each kernel as its ``repro_torch::``
operator: ``torch.library.opcheck`` at a main-path shape, its fake
implementation against its CUDA one at ``tests/test_torch_ops.py``'s
cases, and the CUDA implementation's errors word for word the wrapper's.

Marked ``gpu``; run on a host with a CUDA card and nvcc:

    PYTHONPATH=src python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX, which these tests do
not need and a card's host may not have.)

Whether a card is present is decided inside the ``cuda`` fixture, never
while the module is imported, so every test collects on every host and
skips without a card."""
from __future__ import annotations

import numpy as np
import pytest
import test_torch_ops as op_cases
import torch

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.core import ga, search, space
from repro_torch.imc.cost import DesignArrays, evaluate_designs_arrays
from repro_torch.imc.tables import WorkloadTables, build_tables_arrays
from repro_torch.kernels.ga_gen_step import ref as gref
from repro_torch.kernels.ga_gen_step.ops import ga_gen_step
from repro_torch.kernels.imc_eval import ref as iref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.imc_eval.ops import (
    evaluate_designs_kernel_arrays,
    imc_eval_multi,
    lanes_per_design,
)
from repro_torch.kernels.ssd_scan import ref as sref
from repro_torch.kernels.ssd_scan.ops import ssd_chunked
from repro_torch.launch.serve import build_params, make_burst, serve_burst
from repro_torch.models import transformer
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


def _b1_layers(dev, ws, B, kind, L, seed):
    """feats (B, W, L, 6) and mask (B, W, L): "joint", every search over
    the 4 CNNs; "separate", search b over CNN b alone (W=1); "random", one
    workload (W=1) of L integer-valued random layers."""
    if kind == "joint":
        return (ws.feats[None].expand(B, -1, -1, -1).to(dev).contiguous(),
                ws.mask[None].expand(B, -1, -1).to(dev).contiguous())
    if kind == "separate":
        return ws.feats[:B, None].to(dev), ws.mask[:B, None].to(dev)
    gen = _gen(dev, seed)
    feats = torch.round(torch.randn((B, 1, L, 6), generator=gen, device=dev).abs()
                        * 100 + 1)
    return feats, torch.ones((B, 1, L), dtype=torch.bool, device=dev)


# joint and separate search shapes, then W=1 around the kernel's tiles
# (32 lanes over the layers, 8 designs a block)
@pytest.mark.parametrize("B,P,kind,L", [
    (8, 40, "joint", 64), (3, 129, "joint", 64), (2, 1, "joint", 64),
    (4, 40, "separate", 64),
    *[(2, P, "random", L) for L in (1, 31, 32, 33, 64, 65) for P in (1, 7, 8, 9)],
])
def test_imc_eval_kernel_matches_plain(cuda, ws, B, P, kind, L):
    g = torch.rand((B, P, space.N_GENES), generator=_gen(cuda, P), device=cuda)
    designs = torch.stack(list(space.decode(g)), dim=-1)
    feats, mask = _b1_layers(cuda, ws, B, kind, L, P + L)
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


def test_imc_eval_kernel_bits_do_not_depend_on_the_batch(cuda, ws):
    """A large batch gives each design fewer lanes; the sums keep their bits."""
    B, P = 16, 4096
    g = torch.rand((B, P, space.N_GENES), generator=_gen(cuda, 5), device=cuda)
    designs = torch.stack(list(space.decode(g)), dim=-1)
    feats, mask = _b1_layers(cuda, ws, B, "joint", 0, 0)
    assert lanes_per_design(B, P, 4) < lanes_per_design(1, 40, 4)
    big = imc_eval_multi(designs, feats, mask)
    small = imc_eval_multi(designs[:1, :40].contiguous(), feats[:1], mask[:1])
    for a, b in zip(big, small):
        assert torch.equal(a[:1, :, :40], b)


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


# both sides of the kernel's rank-by-counting / bitonic survival threshold
@pytest.mark.parametrize("P", [40, 128, 129, 300])
def test_ga_gen_step_kernel_adversarial_survival(cuda, ws, P):
    """Parent scores with duplicates, both zero signs, tied +inf, NaN of both
    signs, and the children's own scores (ties across generations): every
    output equal to the plain step's bit for bit (compared as int32, as
    torch.equal is false on NaN)."""
    ctx, pop, scores, u = _b2_case(cuda, ws, P, [[0, 1, 2, 3], [1], [0, 2], [3]], P + 7)
    child_scores = gref.ga_gen_step_ref(pop, scores, u[0], *ctx)[3]
    nan = float("nan")
    special = torch.tensor([0.0, -0.0, float("inf"), float("inf"), nan, -nan, 2.5, 2.5],
                           device=cuda)
    i = torch.arange(P, device=cuda)
    ck = cp = (pop, torch.where(i % 2 == 0, child_scores, special[i % len(special)]))
    for g in range(2):
        k = ga_gen_step(ck[0], ck[1], u[g], ctx)
        p = gref.ga_gen_step_ref(cp[0], cp[1], u[g], *ctx)
        for a, b in zip(k, p):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        ck, cp = k[:2], p[:2]


def test_ga_gen_step_kernel_rejects_what_it_does_not_implement(cuda, ws):
    ctx, pop, scores, u = _b2_case(cuda, ws, 8, [[0, 1]], 0)
    with pytest.raises(ValueError, match="eta"):
        ga_gen_step(pop, scores, u[0], ctx, sbx_eta=2.0)
    big = 1 << 14
    ctx2, pop2, scores2, u2 = _b2_case(cuda, ws, big, [[0]], 1)
    with pytest.raises(ValueError, match="shared memory"):
        ga_gen_step(pop2, scores2, u2[0], ctx2)


def test_search_kernels_on_another_card_keep_the_current_device(cuda, ws):
    """The launchers select the tensors' card in their own runtime and give
    the thread's device back: PyTorch's current device stays where it was,
    and the other card's results equal its plain version's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    other = torch.device("cuda", 1)
    current = torch.cuda.current_device()
    g = torch.rand((2, 40, space.N_GENES), generator=_gen(other, 3), device=other)
    designs = torch.stack(list(space.decode(g)), dim=-1)
    feats, mask = _b1_layers(other, ws, 2, "joint", 0, 0)
    k = imc_eval_multi(designs, feats, mask)
    assert torch.cuda.current_device() == current
    for a, b in zip(k, iref.eval_workloads(designs, feats, mask)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)
    ctx, pop, scores, u = _b2_case(other, ws, 40, [[0, 1, 2, 3], [1]], 2)
    k = ga_gen_step(pop, scores, u[0], ctx)
    assert torch.cuda.current_device() == current
    for a, b in zip(k, gref.ga_gen_step_ref(pop, scores, u[0], *ctx)):
        assert torch.equal(a, b)


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


# ------------------------------------------------------------ DSE service
# the workload subsets of serve.dse.paper_request_mix over the 4 CNNs
_SERVE_SUBSETS = [[0, 1, 2, 3], [0], [1], [2], [3], [0, 1], [1, 2], [2, 3], [3, 0]]


def test_ga_gen_step_64_mixed_slots_match_each_alone(cuda, ws):
    """A service plan's shape: 64 searches over W=1, 2 and 4 sets, tables
    zero-padded to W=4.  The batch's 3 chained generations equal the plain
    version's on the same inputs, and every slot's equal the same search
    run alone on its own unpadded tables, bit for bit."""
    subsets = [_SERVE_SUBSETS[i % 9] for i in range(64)]
    ctx, pop, scores, u = _b2_case(cuda, ws, 40, subsets, 64)
    tables, kind, area = ctx
    batch = [(pop, scores)]
    for g in range(3):
        batch.append(ga_gen_step(*batch[-1], u[g], ctx)[:2])
        plain = gref.ga_gen_step_ref(*batch[-2], u[g], *ctx)[:2]
        for a, c in zip(plain, batch[-1]):
            assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    for b, sub in enumerate(subsets):
        own = WorkloadTables(*(leaf[b:b + 1, :len(sub)].contiguous() for leaf in tables))
        one = (pop[b:b + 1], gref.table_scores(pop[b:b + 1], own, kind[b:b + 1],
                                               area[b:b + 1]))
        assert torch.equal(one[1][0].view(torch.int32), scores[b].view(torch.int32))
        for g in range(3):
            one = ga_gen_step(*one, u[g, b:b + 1].contiguous(),
                              (own, kind[b:b + 1], area[b:b + 1]))[:2]
            for a, c in zip(one, batch[g + 1]):
                assert torch.equal(a[0].view(torch.int32), c[b].view(torch.int32))


def test_imc_eval_service_groups_match_each_alone(cuda, ws):
    """The service's --backend kernel groups (W=4 x 8, W=1 x 28, W=2 x 28
    searches): each search's sums equal the same search alone (B=1)."""
    for W, B in ((4, 8), (1, 28), (2, 28)):
        subs = [s for s in _SERVE_SUBSETS if len(s) == W]
        idx = torch.tensor([subs[b % len(subs)] for b in range(B)])
        feats, mask = ws.feats[idx].to(cuda), ws.mask[idx].to(cuda)
        g = torch.rand((B, 40, space.N_GENES), generator=_gen(cuda, W), device=cuda)
        designs = torch.stack(list(space.decode(g)), dim=-1)
        big = imc_eval_multi(designs, feats, mask)
        for b in range(B):
            one = imc_eval_multi(designs[b:b + 1].contiguous(), feats[b:b + 1].contiguous(),
                                 mask[b:b + 1].contiguous())
            for a, c in zip(one, big):
                assert torch.equal(a[0], c[b])


@pytest.mark.parametrize("backend", ["table", "kernel"])
def test_service_pipelined_equals_sequential_on_card(cuda, ws, backend):
    """A pipelined drain of the service's mix equals the sequential drain
    on every result field and brings fewer bytes to the host."""
    from repro_torch.core.engine import SearchEngine
    from repro_torch.serve.dse import DSEService, paper_request_mix

    reqs = paper_request_mix(ws, 72, backend=backend, pop_size=40, generations=4)
    out, nbytes = {}, {}
    for pipelined in (False, True):
        eng = SearchEngine(device=cuda, pipelined=pipelined)
        svc = DSEService(engine=eng)
        rids = svc.submit_all(reqs)
        res = svc.drain()
        out[pipelined] = [res[r] for r in rids]
        nbytes[pipelined] = eng.transfer_bytes
    assert nbytes[True] < nbytes[False]
    for a, b in zip(out[False], out[True]):
        assert b.ga is None
        np.testing.assert_array_equal(a.top_scores, b.top_scores)
        np.testing.assert_array_equal(a.top_genomes, b.top_genomes)
        np.testing.assert_array_equal(a.convergence, b.convergence)
        assert a.top_designs == b.top_designs and a.valid == b.valid


def test_async_service_worker_keeps_the_card(cuda, ws):
    """The async front end's worker thread runs on the building thread's
    card and answers every future with the sequential drain's bits."""
    from repro_torch.core.engine import SearchEngine
    from repro_torch.serve.dse import AsyncDSEService, paper_request_mix

    reqs = paper_request_mix(ws, 12, backend="table", pop_size=16, generations=2)
    ref = SearchEngine(device=cuda).run(reqs)
    with AsyncDSEService(engine=SearchEngine(device=cuda), policy="priority") as svc:
        got = [f.result(timeout=300) for f in [svc.submit(r) for r in reqs]]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a.top_scores, b.top_scores)
        assert a.top_designs == b.top_designs


# ------------------------------------------------------------- LM kernels
@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,window,q_offset,dtype", [
    (1, 128, 128, 32, 8, 64, 0, 0, torch.bfloat16),
    (1, 1000, 1000, 32, 8, 64, 0, 0, torch.bfloat16),  # ragged KV tail
    (2, 100, 128, 4, 2, 64, 0, 0, torch.float32),       # ragged Sq
    (1, 256, 256, 4, 2, 64, 96, 0, torch.float32),      # sliding window
    (1, 64, 192, 4, 2, 64, 0, 128, torch.float32),      # q_offset
    (2, 128, 128, 4, 1, 80, 0, 0, torch.float32),       # D=80
    (1, 64, 64, 2, 2, 128, 0, 0, torch.bfloat16),
    (1, 64, 128, 4, 2, 32, 32, 400, torch.float32),     # rows with no valid key
    # the tensor-core (bf16) kernel at the shapes above
    (2, 100, 128, 4, 2, 64, 0, 0, torch.bfloat16),
    (1, 256, 256, 4, 2, 64, 96, 0, torch.bfloat16),
    (1, 64, 192, 4, 2, 64, 0, 128, torch.bfloat16),
    (2, 128, 128, 4, 1, 80, 0, 0, torch.bfloat16),
    (1, 128, 128, 4, 2, 16, 0, 0, torch.bfloat16),
    (1, 100, 200, 4, 2, 128, 0, 100, torch.bfloat16),
    (1, 64, 128, 4, 2, 32, 32, 400, torch.bfloat16),
    (1, 96, 96, 2, 1, 36, 0, 0, torch.bfloat16),        # D not a multiple of 8
    # gemma's head dim (256): a window, a ragged Skv, rows with no valid key
    (1, 256, 256, 4, 2, 256, 96, 0, torch.bfloat16),
    (1, 200, 328, 4, 4, 256, 0, 128, torch.bfloat16),
    (1, 64, 128, 4, 2, 256, 32, 400, torch.bfloat16),
    (1, 256, 256, 4, 2, 256, 96, 0, torch.float32),
    (1, 64, 128, 4, 2, 256, 32, 400, torch.float32),
])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Skv, H, KV, D, window,
                                              q_offset, dtype):
    gen = _gen(cuda, Sq + D)
    q = torch.randn((B, Sq, H, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, Skv, KV, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, Skv, KV, D), generator=gen, device=cuda).to(dtype)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    before = flash_attention.launches
    o = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    r = attention_reference(q, k, v, **kw)
    assert o.dtype == dtype
    tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
    assert float((o.float() - r.float()).abs().max()) <= tol


# the prefill shapes of the MoE, VLM and enc-dec models: mixtral (window
# 4096), qwen3-moe, qwen2-vl, whisper's encoder and cross-attention
# (non-causal MHA), and a cross-attention of fewer queries than frames
@pytest.mark.parametrize("Sq,Skv,H,KV,D,causal,window", [
    (1024, 1024, 32, 8, 128, True, 4096),
    (1024, 1024, 16, 16, 256, True, 0),  # gemma-7b
    (1024, 1024, 64, 4, 128, True, 0),
    (2048, 2048, 12, 2, 128, True, 0),
    (1024, 1024, 16, 16, 64, False, 0),
    (512, 1024, 16, 16, 64, False, 0),
])
def test_flash_attention_kernel_at_model_shapes(cuda, Sq, Skv, H, KV, D, causal, window):
    gen = _gen(cuda, Sq + H)
    q, k, v = (torch.randn((1, n, h, D), generator=gen, device=cuda).to(torch.bfloat16)
               for n, h in ((Sq, H), (Skv, KV), (Skv, KV)))
    kw = dict(causal=causal, window=window)
    before = flash_attention.launches
    o = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before + 1
    r = attention_reference(q, k, v, **kw)
    assert float((o.float() - r.float()).abs().max()) <= 3e-2


@pytest.mark.parametrize("Sq,Skv", [(200, 200), (1500, 1500), (200, 1500)])
def test_flash_attention_kernel_at_ragged_frame_counts(cuda, Sq, Skv):
    """whisper's non-causal encoder and cross-attention over frame counts
    that are not a multiple of the 128-row KV block (200, and whisper's
    1500): the models pass ``ragged_kv=True`` and the kernel masks the
    ragged last tile."""
    gen = _gen(cuda, Sq + Skv)
    q, k, v = (torch.randn((1, n, 16, 64), generator=gen, device=cuda).to(torch.bfloat16)
               for n in (Sq, Skv, Skv))
    before = flash_attention.launches
    o = flash_attention(q, k, v, causal=False, ragged_kv=True)
    assert flash_attention.launches == before + 1
    r = attention_reference(q, k, v, causal=False)
    assert float((o.float() - r.float()).abs().max()) <= 3e-2


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_moe_route_on_card_equals_cpu_at_qwen3_moe_shape(cuda, capacity_factor):
    """qwen3-moe's routing (E=128, top-8, S=1024, d=4096) at its own
    capacity factor (C=80) and at 0.5 (many drops): the same experts, queue
    positions and kept set on the card as on the CPU.  x and the router
    hold small integers (the router's times 2^-6), so the float32 router
    logits are exact on both devices, and ~270 tokens tie somewhere in
    their top 9: the two stable sorts must break those ties alike."""
    from repro_torch.models import moe

    cfg = get_config("qwen3-moe-235b-a22b")
    cf = cfg.capacity_factor if capacity_factor is None else capacity_factor
    S, d, E, k = 1024, cfg.d_model, cfg.n_experts, cfg.topk
    gen = torch.Generator().manual_seed(7)
    x = torch.randint(-2, 3, (1, S, d), generator=gen).to(torch.bfloat16)
    r = torch.randint(-2, 3, (d, E), generator=gen).float() * 2.0 ** -6
    rc = moe.moe_route(x, r, topk=k, capacity_factor=cf)
    rg = moe.moe_route(x.to(cuda), r.to(cuda), topk=k, capacity_factor=cf)
    assert rg.capacity == rc.capacity == moe.moe_capacity(S, E, k, cf)
    for f in ("topi", "pos", "keep"):
        assert torch.equal(getattr(rg, f).cpu(), getattr(rc, f)), f
    assert int((~rc.keep).sum()) > 0


@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.3])
def test_moe_ffn_on_card_equals_cpu(cuda, capacity_factor):
    """The same bf16 inputs on the card and on the CPU: the same experts
    and kept entries, outputs within two bf16 ulps of their scale (cuBLAS
    and the CPU sum the expert products in other orders)."""
    from repro_torch.models import moe

    gen = torch.Generator().manual_seed(int(capacity_factor * 10))
    B, S, d, E, f, k = 2, 256, 64, 8, 128, 2
    x = torch.randn((B, S, d), generator=gen).to(torch.bfloat16)
    r = torch.randn((d, E), generator=gen)
    wg, wu = ((torch.randn((E, d, f), generator=gen) * 0.1).to(torch.bfloat16) for _ in range(2))
    wd = (torch.randn((E, f, d), generator=gen) * 0.1).to(torch.bfloat16)
    kw = dict(topk=k, capacity_factor=capacity_factor)
    rc = moe.moe_route(x, r, **kw)
    rg = moe.moe_route(x.to(cuda), r.to(cuda), **kw)
    assert torch.equal(rg.topi.cpu(), rc.topi) and torch.equal(rg.keep.cpu(), rc.keep)
    yc, ac = moe.moe_ffn(x, r, wg, wu, wd, **kw)
    yg, ag = moe.moe_ffn(*(t.to(cuda) for t in (x, r, wg, wu, wd)), **kw)
    scale = max(float(yc.float().abs().max()), 1.0)
    assert float((yg.cpu().float() - yc.float()).abs().max()) <= 2.0 ** -7 * scale
    assert abs(float(ag) - float(ac)) <= 1e-5


def test_flash_attention_kernel_refuses(cuda):
    q = torch.zeros((1, 64, 4, 16), device=cuda)
    k = torch.zeros((1, 200, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="non-causal"):
        flash_attention(q, k, k, causal=False)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 8, 2, 264), device=cuda)
        flash_attention(big, big, big)


def test_flash_attention_on_a_second_card(cuda):
    """The kernels' shared-memory opt-in is kept per (device, size): the
    D=128 bf16 kernel (225 KB) and the float32 kernel, launched on cuda:0
    first, launch on cuda:1 too and match the plain version there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    for dtype in (torch.bfloat16, torch.float32):
        for dev in (cuda, torch.device("cuda", 1)):
            gen = _gen(dev, 5)
            q = torch.randn((1, 256, 8, 128), generator=gen, device=dev).to(dtype)
            k = torch.randn((1, 256, 2, 128), generator=gen, device=dev).to(dtype)
            v = torch.randn((1, 256, 2, 128), generator=gen, device=dev).to(dtype)
            before = flash_attention.launches
            o = flash_attention(q, k, v)
            assert flash_attention.launches == before + 1 and o.device == dev
            tol = 3e-2 if dtype == torch.bfloat16 else 2e-5
            assert float((o.float() - attention_reference(q, k, v).float()).abs().max()) <= tol


@pytest.mark.parametrize("B,S,H,P,N,chunk,dtype", [
    (1, 96, 48, 64, 128, 128, torch.float32),
    (2, 256, 4, 64, 128, 128, torch.float32),
    (1, 128, 8, 32, 64, 32, torch.float32),
    (2, 64, 2, 16, 32, 64, torch.float32),
    (1, 1024, 48, 64, 128, 128, torch.bfloat16),
    # the chunk-parallel (bf16) kernels: chunks < 128, B=2, ragged chunks
    # and widths that are not multiples of 4 or 8
    (1, 96, 48, 64, 128, 128, torch.bfloat16),
    (2, 256, 4, 64, 128, 128, torch.bfloat16),
    (1, 128, 8, 32, 64, 32, torch.bfloat16),
    (2, 64, 2, 16, 32, 64, torch.bfloat16),
    (1, 512, 4, 64, 128, 128, torch.bfloat16),
    (2, 100, 3, 24, 40, 128, torch.bfloat16),
    (1, 60, 2, 12, 20, 128, torch.bfloat16),
    (1, 256, 2, 80, 160, 128, torch.bfloat16),
    (1, 1024, 128, 64, 16, 128, torch.bfloat16),  # jamba's Mamba layers (N=16)
])
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, N, chunk, dtype):
    _check_ssd(cuda, B, S, H, P, N, chunk, dtype)


def test_ssd_scan_bf16_sixteen_chunks(cuda):
    """mamba2's widths at S=2048: 16 chunks through the state pass."""
    _check_ssd(cuda, 1, 2048, 48, 64, 128, 128, torch.bfloat16)


def _check_ssd(cuda, B, S, H, P, N, chunk, dtype):
    gen = _gen(cuda, S + N)
    x = torch.randn((B, S, H, P), generator=gen, device=cuda).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=cuda))
    A = -torch.exp(torch.randn((H,), generator=gen, device=cuda) * 0.5)
    Bm = torch.randn((B, S, 1, N), generator=gen, device=cuda).to(dtype)
    Cm = torch.randn((B, S, 1, N), generator=gen, device=cuda).to(dtype)
    h0 = torch.randn((B, H, N, P), generator=gen, device=cuda)
    for init in (None, h0):
        before = ssd_chunked.launches
        y, h = ssd_chunked(x, dt, A, Bm, Cm, init, chunk=chunk)
        assert ssd_chunked.launches == before + 1
        yr, hr = sref.ssd_chunked(x, dt, A, Bm, Cm, init, chunk=chunk)
        # 1e-4 of the output's scale; bf16 y is rounded by both (1e-2)
        ty = (1e-2 if dtype == torch.bfloat16 else 1e-4) * max(1.0, float(yr.float().abs().max()))
        assert float((y.float() - yr.float()).abs().max()) <= ty
        assert float((h - hr).abs().max()) <= 1e-4 * max(1.0, float(hr.abs().max()))


def _ssd_model_inputs(cuda, B, S, H, N, seed):
    """bf16 inputs at a model's widths (P=64), the kernel tests'
    distributions, and an initial state."""
    gen = _gen(cuda, seed)
    x = torch.randn((B, S, H, 64), generator=gen, device=cuda).bfloat16()
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen, device=cuda))
    A = -torch.exp(torch.randn((H,), generator=gen, device=cuda) * 0.5)
    Bm = torch.randn((B, S, 1, N), generator=gen, device=cuda).bfloat16()
    Cm = torch.randn((B, S, 1, N), generator=gen, device=cuda).bfloat16()
    h0 = torch.randn((B, H, N, 64), generator=gen, device=cuda)
    return x, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("H,N", [(48, 128), (128, 16)])  # mamba2-780m, jamba
def test_ssd_scan_rows_and_heads_keep_their_bits(cuda, H, N):
    """A (batch row, head)'s y and final state do not depend on the rest of
    the call: each row of a B=4 call, and heads 0..7, equal bit for bit
    the same row or heads run alone (the mesh paths rely on it)."""
    x, dt, A, Bm, Cm, h0 = _ssd_model_inputs(cuda, 4, 1024, H, N, 11)
    y, h = ssd_chunked(x, dt, A, Bm, Cm, h0)
    for b in range(4):
        r = slice(b, b + 1)
        yb, hb = ssd_chunked(x[r], dt[r], A, Bm[r], Cm[r], h0[r])
        assert torch.equal(yb, y[r]) and torch.equal(hb, h[r]), b
    hs = slice(0, 8)
    yh, hh = ssd_chunked(x[:, :, hs].contiguous(), dt[:, :, hs].contiguous(), A[hs].contiguous(),
                         Bm, Cm, h0[:, hs].contiguous())
    assert torch.equal(yh, y[:, :, hs]) and torch.equal(hh, h[:, hs])


@pytest.mark.parametrize("H,N", [(48, 128), (128, 16)])  # mamba2-780m, jamba
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_within_the_float64_margin(cuda, H, N, with_h0):
    """At a model's widths, the kernel's y lies at most one bf16 ulp (2^-7
    of the largest |y|, ``chip_smoke.py``'s ``SSD_Y_MARGIN``) further from
    the scan in float64 than the plain scan's y, and its final state
    within 1e-4 of the plain one's scale."""
    x, dt, A, Bm, Cm, h0 = _ssd_model_inputs(cuda, 1, 1024, H, N, 12)
    h0 = h0 if with_h0 else None
    y, h = ssd_chunked(x, dt, A, Bm, Cm, h0)
    yp, hp = sref.ssd_chunked(x, dt, A, Bm, Cm, h0)
    f64 = [None if t is None else t.double() for t in (x, dt, A, Bm, Cm, h0)]
    y64, _ = sref.ssd_chunked(*f64, compute_dtype=torch.float64)
    scale = y64.abs().max()
    extra = float(((y.double() - y64).abs().max() - (yp.double() - y64).abs().max()) / scale)
    assert extra <= 2.0 ** -7
    assert float((h - hp).abs().max()) <= 1e-4 * max(1.0, float(hp.abs().max()))


def test_ssd_scan_kernel_refuses(cuda):
    x = torch.zeros((1, 64, 2, 8), device=cuda)
    dt = torch.zeros((1, 64, 2), device=cuda)
    A = torch.zeros((2,), device=cuda)
    with pytest.raises(ValueError, match="G=1"):
        ssd_chunked(x, dt, A, torch.zeros((1, 64, 2, 16), device=cuda),
                    torch.zeros((1, 64, 2, 16), device=cuda))
    with pytest.raises(ValueError, match="chunk"):
        b = torch.zeros((1, 64, 1, 16), device=cuda)
        ssd_chunked(x, dt, A, b, b, chunk=48)


@pytest.mark.parametrize("name,counter", [("llama3.2-1b", flash_attention),
                                          ("mamba2-780m", ssd_chunked)])
def test_engine_runs_through_kernels_on_card(cuda, name, counter):
    cfg = get_config(name).reduced()
    params = build_params(cfg, 0, cuda)
    counter.launches = 0
    done, st = serve_burst(cfg, params, make_burst(cfg, 4, 0), slots=2, max_len=1100)
    assert counter.launches == cfg.n_layers * st["prefills"] == cfg.n_layers * 4
    assert all(len(r.out) == r.max_new for r in done)
    # the kernel path against the plain path, same weights
    toks = torch.as_tensor(done[0].prompt[None].astype(np.int64), device=cuda)
    with torch.inference_mode():
        lk, _ = transformer.prefill(cfg, params, toks, impl="kernel")
        lp, _ = transformer.prefill(cfg, params, toks, impl="plain")
    assert float((lk.float() - lp.float()).abs().max()) <= 0.1


# ------------------------------------- objectives, NSGA-II, direct seeding
def _same_inputs(P, G, B, seed):
    g = torch.Generator().manual_seed(seed)
    init = torch.rand((B, P, space.N_GENES), generator=g)
    u = torch.rand((B, G, ga.block_layout(P, space.N_GENES).tot), generator=g)
    return init, u


@pytest.mark.parametrize("area", [150.0, 1e9])
@pytest.mark.parametrize("backend", ["table", "kernel"])
def test_pareto_and_weighted_searches_on_card_equal_cpu(cuda, ws, backend, area):
    """Given the same populations and blocks, the Pareto and weighted
    searches on the card give the CPU's fronts and bests: the same decoded
    designs, in the same order, with vectors and scores within rtol 1e-5
    (the dense and table cost models round alike on both devices up to the
    order of their sums).  At the paper's 150 mm^2 some seeds fail on area
    alone, so the tails' area term marks rows +inf; 1e9 never binds."""
    from repro_torch.core.engine import SearchEngine

    P, G, B = 16, 3, 3
    _, u = _same_inputs(P, G, B, 5)
    # populations that fit the set (the paper's seeding rule, CPU streams)
    init = torch.stack([search.seed_population(b, ws, P, device="cpu") for b in range(B)])
    if area < 1e9:
        r = evaluate_designs_arrays(space.decode(init.reshape(-1, space.N_GENES)), ws.feats,
                                    ws.mask)
        assert bool((r.area_mm2 > area).any()) and bool((r.area_mm2 <= area).any())
    feats = ws.feats[None].expand(B, -1, -1, -1)
    mask = ws.mask[None].expand(B, -1, -1)
    common = dict(pop_size=P, generations=G, init_genomes=init.numpy(), u_blocks=u.numpy(),
                  backend=backend, area_constr=area)
    runs = {}
    for dev in ("cpu", cuda):
        eng = SearchEngine(device=dev)
        runs[str(dev)] = (
            search.batched_search([0, 1, 2], feats, mask, objective="pareto", pareto_k=6,
                                  engine=eng, **common),
            search.batched_search([0, 1, 2], feats, mask,
                                  obj_weights=[(1.0, 1.0, 0.0), (0.5, 2.0, 1.5), (1, 1, 1)],
                                  engine=eng, **common))
    assert any(r.valid for res in runs["cpu"] for r in res)
    for cpu_res, card_res in zip(runs["cpu"], runs[str(cuda)]):
        for a, b in zip(cpu_res, card_res):
            assert a.objective == b.objective and a.valid == b.valid
            np.testing.assert_array_equal(space.decode_indices_np(a.top_genomes),
                                          space.decode_indices_np(b.top_genomes))
            np.testing.assert_allclose(b.top_scores, a.top_scores, rtol=1e-5)
            if a.objective_vectors is not None:
                np.testing.assert_allclose(b.objective_vectors, a.objective_vectors,
                                           rtol=1e-5)


def test_direct_seed_on_card_equals_cpu(cuda, ws):
    """The direct seeder fed the same uniforms and CDFs: the same genomes,
    bit for bit, on both devices; every seed fits and is V/f-valid."""
    from repro_torch.core import engine as eng_mod
    from repro_torch.core.engine import SearchEngine, SearchRequest

    reqs = [SearchRequest(ws=ws.subset(s), backend="table") for s in ([0], [1, 2], [0, 1, 2, 3])]
    u = torch.rand((3, 40, space.N_GENES + 2), generator=torch.Generator().manual_seed(2))
    cdf = SearchEngine(device="cpu")._stacked_seed_cdf(reqs, reqs[0].tech)
    cpu_pools, cpu_counts = eng_mod._seed_direct(u, cdf, reqs[0].tech)
    card = SearchEngine(device=cuda)
    pools, counts = eng_mod._seed_direct(u.to(cuda), card._stacked_seed_cdf(reqs, reqs[0].tech),
                                         reqs[0].tech)
    assert torch.equal(pools.cpu(), cpu_pools) and torch.equal(counts.cpu(), cpu_counts)
    direct = SearchEngine(device=cuda, direct_seed=True).run(
        [SearchRequest(ws=r.ws, backend="table", pop_size=40, generations=2, seed=i)
         for i, r in enumerate(reqs)])
    for r, d in zip(reqs, direct):
        wi = eng_mod.largest_workload_index(r.ws)
        g0 = torch.from_numpy(d.ga.genomes[0]).to(cuda)
        ev = evaluate_designs_arrays(space.decode(g0), r.ws.feats[wi][None].to(cuda),
                                     r.ws.mask[wi][None].to(cuda))
        assert bool(ev.fits.all()) and bool(ev.valid.all())


def test_seeding_stream_keeps_the_pools(cuda, ws):
    """The rejection seeder on the engine's seeding stream draws the pools
    it draws on the current stream, and a later GA on the current stream
    reads them complete."""
    from repro_torch.core import engine as eng_mod
    from repro_torch.core.engine import SearchEngine, plan_batch
    from repro_torch.serve.dse import paper_request_mix

    reqs = paper_request_mix(ws, 9, pop_size=40, generations=2)
    plan = plan_batch(reqs)[0]
    eng = SearchEngine(device=cuda)
    feats, mask = eng._packed(plan.requests, plan.pad_w, plan.pad_l)
    torch.cuda.synchronize()

    def gens():
        return [eng_mod._slot_generators(r.seed, cuda)[0] for r in plan.requests]

    on_stream = eng_mod._seed_pools(gens(), feats, mask, 40, tech=plan.requests[0].tech,
                                    stream=eng._seed_stream)
    plain = eng_mod._seed_pools(gens(), feats, mask, 40, tech=plan.requests[0].tech)
    for a, b in zip(on_stream, plain):
        assert torch.equal(a, b)
    res = eng.run(reqs)
    alone = [SearchEngine(device=cuda).run([r])[0] for r in reqs[:3]]
    for a, b in zip(res[:3], alone):
        np.testing.assert_array_equal(a.ga.genomes, b.ga.genomes)


def test_dispatch_does_not_wait_for_work_queued_before_it(cuda, ws):
    """A pipelined dispatch behind ~0.5 s of device work queued on the
    current stream returns before that work ends: the seeder's reads wait
    on its own stream only.  Its results equal a dispatch on an idle card."""
    from repro_torch.core.engine import SearchEngine, plan_batch
    from repro_torch.serve.dse import paper_request_mix

    plan = plan_batch(paper_request_mix(ws, 9, pop_size=40, generations=3))[0]
    eng = SearchEngine(device=cuda, pipelined=True)
    idle = eng.harvest(eng.dispatch(plan))
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    slept = torch.cuda.Event()
    slept.record()
    pend = eng.dispatch(plan)
    assert not slept.query()
    for a, b in zip(idle, eng.harvest(pend)):
        np.testing.assert_array_equal(a.top_genomes, b.top_genomes)
        np.testing.assert_array_equal(a.top_scores, b.top_scores)


# --------------------------------------------------- decode attention, C.4
@pytest.mark.parametrize("B,S,H,KV,D,valid", [(4, 2048, 32, 8, 64, (2048, 700, 1, 1500)),
                                              (1, 96, 8, 8, 128, None),
                                              (2, 33, 4, 1, 16, (33, 5))])
def test_decode_attention_bf16_path_matches_widened(cuda, B, S, H, KV, D, valid):
    """The bf16 products with float32 accumulation against the widened
    float32 einsum on the same card tensors: scores and values rtol 1e-5,
    the bf16 output within one bf16 rounding (2e-2 of its scale)."""
    from repro_torch.models import attention as attn

    g = _gen(cuda, 3)
    q = torch.randn((B, 1, H, D), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((B, S, KV, D), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((B, S, KV, D), generator=g, device=cuda).to(torch.bfloat16)
    qf = (q * D ** -0.5).to(k.dtype).reshape(B, 1, KV, H // KV, D)
    s = attn._decode_scores(qf, k)
    s_w = torch.einsum("bqkgd,bskd->bkgqs", qf.float(), k.float())
    torch.testing.assert_close(s, s_w, rtol=1e-5, atol=1e-5)
    p = torch.softmax(s_w, dim=-1).to(v.dtype)
    o = attn._decode_values(p, v)
    o_w = torch.einsum("bkgqs,bskd->bkgqd", p.float(), v.float())
    torch.testing.assert_close(o, o_w, rtol=1e-5, atol=1e-5)
    out = attn.decode_attention(q, k, v, valid_len=None if valid is None
                                else torch.tensor(valid, device=cuda))
    ref = attn.decode_attention(q.cpu(), k.cpu(), v.cpu(), valid_len=None if valid is None
                                else torch.tensor(valid))
    scale = float(ref.float().abs().max())
    assert float((out.cpu().float() - ref.float()).abs().max()) <= 2e-2 * max(1.0, scale)


def _drop_own_term(real):
    """An ``ssd_chunked`` with one fault: a strict causal mask, so each
    position loses its own term ``(C_t . B_t) dt_t x_t``."""
    def scan(x, dt, A, Bm, Cm, h0=None, *, chunk=128):
        y, h = real(x, dt, A, Bm, Cm, h0, chunk=chunk)
        own = (Cm.float() * Bm.float()).sum(-1)[..., None] * dt.float()[..., None] * x.float()
        return (y.float() - own).to(y.dtype), h
    return scan


def _drop_last_chunk_inter(real):
    """An ``ssd_chunked`` with one fault: the last chunk's y loses its
    inter-chunk term (it is scanned again from a zero state)."""
    def scan(x, dt, A, Bm, Cm, h0=None, *, chunk=128):
        y, h = real(x, dt, A, Bm, Cm, h0, chunk=chunk)
        lo = x.shape[1] - min(chunk, x.shape[1])
        y_last, _ = real(x[:, lo:], dt[:, lo:], A, Bm[:, lo:], Cm[:, lo:], None, chunk=chunk)
        return torch.cat([y[:, :lo], y_last], dim=1), h
    return scan


def test_mamba_float64_gap_check_catches_a_faulty_scan(cuda, monkeypatch):
    """At mamba2-780m's full width (48 layers, random weights), every scan
    call of a kernel-path prefill, held on its own inputs against the scan
    in float64, lies at most one bf16 ulp (2^-7 of the call's largest |y|)
    further than the plain scan, the margin ``chip_smoke.py`` states; a
    scan whose last chunk drops its inter-chunk term, and one whose causal
    mask drops each position's own term, do not."""
    import types

    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import mamba

    margin = 2.0 ** -7
    cfg = get_config("mamba2-780m")
    params = build_params(cfg, 0, cuda)
    toks = torch.randint(0, cfg.vocab_size, (1, 512), generator=_gen(cuda, 4), device=cuda)

    def f64(t):
        return None if t is None else t.double()

    def extra_gap(make):
        """The largest (kernel gap - plain gap) over the prefill's calls."""
        gaps = []

        def scan(x, dt, A, Bm, Cm, h0=None, *, chunk=128):
            y, h = make(ssd_ops.ssd_chunked)(x, dt, A, Bm, Cm, h0, chunk=chunk)
            yp, _ = sref.ssd_chunked(x, dt, A, Bm, Cm, h0, chunk=chunk)
            y64, _ = sref.ssd_chunked(f64(x), f64(dt), f64(A), f64(Bm), f64(Cm), f64(h0),
                                      chunk=chunk, compute_dtype=torch.float64)
            scale = y64.abs().max()
            gaps.append(float(((y.double() - y64).abs().max()
                               - (yp.double() - y64).abs().max()) / scale))
            return y, h

        monkeypatch.setattr(mamba, "ssd_ops", types.SimpleNamespace(ssd_chunked=scan))
        with torch.inference_mode():
            transformer.prefill(cfg, params, toks, impl="kernel")
        assert len(gaps) == cfg.n_layers
        return max(gaps)

    assert extra_gap(lambda real: real) <= margin
    for fault in (_drop_last_chunk_inter, _drop_own_term):
        assert extra_gap(fault) > margin, fault.__name__


# ------------------------------------------------------------- training
# one train step on the card against the CPU (the bounds of chip_smoke.py
# phase 10b and tests/test_torch_train.py: bf16 activations round on the
# card's GEMMs as in another framework)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-3, 1e-2
TRAIN_GRAD_REL_L2, TRAIN_UPDATE_REL_L2 = 0.1, 0.3


def _train_state(cfg, seed=0):
    """Float32 masters from ``seed`` on the CPU with zeroed routers (every
    probability ties, so both devices route alike), requiring grad, and a
    train batch from the data pipeline."""
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.launch.cells import input_specs
    from repro_torch.models.common import tree_leaves

    params = transformer.init(cfg, torch.Generator().manual_seed(seed))
    for slot in params["blocks"]:
        if "router" in slot.get("ffn", {}):
            slot["ffn"]["router"].zero_()
    for p in tree_leaves(params):
        p.requires_grad_()
    extras = {k: v for k, v in input_specs(cfg, ShapeSpec("t", 64, 4, "train")).items()
              if k not in ("inputs", "targets")}
    return params, make_batch_fn(cfg.vocab_size, 64, 4, seed=seed, extras=extras)(0)


def _on(tree, dev):
    from repro_torch.models.common import tree_flatten, tree_unflatten

    leaves, td = tree_flatten(tree)
    return tree_unflatten(td, [x.detach().to(dev, copy=True).requires_grad_(x.requires_grad)
                               for x in leaves])


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("name", ["llama3.2-1b", "mamba2-780m", "mixtral-8x7b"])
def test_train_step_on_card_equals_cpu(cuda, name):
    from repro_torch.data.pipeline import to_device
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import loss_fn, make_train_step

    cfg = get_config(name).reduced()
    params, host = _train_state(cfg)
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    cpu = torch.device("cpu")
    # step 0 (learning rate 0) on the CPU fills the moments
    params, opt, _ = make_train_step(cfg, **kw)(params, adamw_init(params),
                                                to_device(host, cpu))
    grads = []
    for d in (cuda, cpu):
        p = _on(params, d)
        grads.append(torch.autograd.grad(loss_fn(cfg, p, to_device(host, d))[0],
                                         tree_leaves(p)))
    assert max(_rel(a, b) for a, b in zip(*grads)) <= TRAIN_GRAD_REL_L2
    before = [x.detach().clone() for x in tree_leaves(params)]
    outs = []
    for d in (cuda, cpu):
        p, o, m = make_train_step(cfg, **kw)(_on(params, d), _on(opt, d), to_device(host, d))
        assert int(o.step) == 2
        outs.append(([x.detach().cpu() for x in tree_leaves(p)],
                     {k: float(v) for k, v in m.items()}))
    (pg, mg), (pc, mc) = outs
    assert mg["loss"] == pytest.approx(mc["loss"], rel=TRAIN_LOSS_RTOL)
    assert mg["grad_norm"] == pytest.approx(mc["grad_norm"], rel=TRAIN_GNORM_RTOL)
    assert mg["lr"] == mc["lr"]
    assert max(_rel(a - x, b - x) for a, b, x in zip(pg, pc, before)) <= TRAIN_UPDATE_REL_L2


def test_train_remat_on_and_off_on_card(cuda):
    """The same step with and without remat on the card: the forward is the
    same operations, the backward recomputes them."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.step import loss_fn

    cfg = get_config("llama3.2-1b").reduced()
    params, host = _train_state(cfg)
    p = _on(params, cuda)
    batch = to_device(host, cuda)
    out = []
    for remat in (True, False):
        loss, _ = loss_fn(cfg, p, batch, remat=remat, loss_chunk=16)
        out.append((loss.detach(), torch.autograd.grad(loss, tree_leaves(p))))
    assert torch.equal(out[0][0], out[1][0])
    assert max(_rel(a, b) for a, b in zip(out[0][1], out[1][1])) <= 1e-5


@pytest.mark.parametrize("name", ["llama3.2-1b", "mamba2-780m"])
def test_training_launches_no_kernel(cuda, name):
    """A train step runs the plain attention and SSD: B1-B4 launch 0 times."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step

    cfg = get_config(name).reduced()
    params, host = _train_state(cfg)
    p = _on(params, cuda)
    counters = (imc_eval_multi, ga_gen_step, flash_attention, ssd_chunked)
    for c in counters:
        c.launches = 0
    step = make_train_step(cfg, total_steps=10)
    opt = adamw_init(p)
    for _ in range(2):
        p, opt, m = step(p, opt, to_device(host, cuda))
    assert np.isfinite(float(m["loss"]))
    assert [c.launches for c in counters] == [0, 0, 0, 0]


def test_batches_reach_the_card_from_pinned_memory(cuda):
    from repro_torch.data.pipeline import make_batch_fn, pinned, to_device

    b = make_batch_fn(1000, 32, 2, seed=3, extras={"mrope_pos": ((3, 2, 32), torch.int64)})(4)
    host = pinned(b)
    assert all(t.is_pinned() for t in host.values())
    dev = to_device(host, cuda)
    torch.cuda.synchronize()
    assert dev["inputs"].is_cuda and dev["inputs"].dtype == torch.int64
    for k in b:
        np.testing.assert_array_equal(dev[k].cpu().numpy(), b[k])


# ------------------------------------------------- threefry streams on the card
def test_threefry_draws_on_card_equal_cpu(cuda):
    """The JAX package's streams (``core/prng.py``) give the same bits on
    the card and the CPU, at the engine's shapes (a service plan's stream,
    one seeder round); gumbel within 1e-6 (the two devices' ``log``)."""
    from repro_torch.core import prng

    for seed in (0, 1, 2**31 - 1, 2**32 + 3, -1):
        assert torch.equal(prng.PRNGKey(seed, device=cuda).cpu(), prng.PRNGKey(seed))
    keys = prng.split(prng.PRNGKey(3), 64)
    for n in (2, 8, 64):
        assert torch.equal(prng.split(keys.to(cuda), n).cpu(), prng.split(keys, n))
    k_gen = prng.split(prng.split(keys)[:, 1], 10)
    for k, shape in ((k_gen, (1180,)), (keys, (2560, 9)), (keys[:3], (7, 5))):
        got = prng.uniform(k.to(cuda), shape).cpu()
        assert torch.equal(got.view(torch.int32), prng.uniform(k, shape).view(torch.int32))
    got = prng.uniform(keys.to(cuda), (100,), minval=-2.0, maxval=3.5).cpu()
    want = prng.uniform(keys, (100,), minval=-2.0, maxval=3.5)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    g = prng.gumbel(keys[:8].to(cuda), (32000,)).cpu()
    torch.testing.assert_close(g, prng.gumbel(keys[:8], (32000,)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("direct", [False, True])
def test_threefry_table_search_on_card_gives_cpu_generation0(cuda, ws, direct):
    from repro_torch.core.engine import SearchEngine, SearchRequest

    reqs = [SearchRequest(ws=ws, seed=s, backend="table", pop_size=40, generations=2)
            for s in range(4)]
    card, cpu = (SearchEngine(device=d, prng="threefry", direct_seed=direct).run(reqs)
                 for d in (cuda, "cpu"))
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a.ga.genomes[0].view(np.int32),
                                      b.ga.genomes[0].view(np.int32))


def _nccl_rank(rank: int, world: int, store: str, out: str) -> None:
    """One card's rank of ``test_search_mesh_over_two_cards_under_nccl``."""
    import datetime
    import pickle

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_search_mesh

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        ws = pack_workloads([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])
        got = {}
        for shape in ((2, 1), (1, 2)):
            mesh = make_search_mesh(*shape, device_type="cuda", timeout_s=120)
            for backend in ("kernel", "table"):
                imc_eval_multi.launches = ga_gen_step.launches = 0
                res = search.joint_search_batched(
                    [0, 1, 2, 3], ws, pop_size=16, generations=3, backend=backend,
                    device=torch.device("cuda", rank), mesh=mesh)
                got[(shape, backend)] = (
                    [(r.top_scores, r.top_genomes, r.ga.scores) for r in res],
                    imc_eval_multi.launches, ga_gen_step.launches)
        with open(f"{out}.{rank}", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def test_search_mesh_over_two_cards_under_nccl(cuda, ws, tmp_path):
    """Two ranks, one card each, NCCL: the searches split over ``search``
    (2x1) or each population over ``data`` (1x2) give the meshless run's
    bits on every rank, each rank launching its backend's kernel."""
    import pickle

    import torch.multiprocessing as mp

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    ctx = mp.start_processes(_nccl_rank, args=(2, str(tmp_path / "store"), str(tmp_path / "o")),
                             nprocs=2, join=False, start_method="spawn")
    try:
        for _ in range(300):
            if ctx.join(timeout=1.0):
                break
        else:
            raise AssertionError("the two NCCL ranks passed their 300 s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [pickle.load(open(tmp_path / f"o.{r}", "rb")) for r in range(2)]
    for backend in ("kernel", "table"):
        ref = search.joint_search_batched([0, 1, 2, 3], ws, pop_size=16, generations=3,
                                          backend=backend, device=cuda)
        for got in ranks:
            for shape in ((2, 1), (1, 2)):
                res, b1, b2 = got[(shape, backend)]
                assert (b1 > 0) if backend == "kernel" else (b2 > 0 and b1 == 0)
                for (s, g, h), r in zip(res, ref):
                    np.testing.assert_array_equal(s.view(np.uint32), r.top_scores.view(np.uint32))
                    np.testing.assert_array_equal(g, r.top_genomes)
                    np.testing.assert_array_equal(h.view(np.uint32), r.ga.scores.view(np.uint32))


# ------------------------------------------------ the repro_torch operators
def _opcheck_args(name, cuda, ws):
    """One call per operator at a main-path shape: B1 and B2 at the joint
    search's (B=8 searches over the paper's 4 CNNs, P=40), B3 at llama's
    prefill (S=128, bf16), B4 at mamba2's (S=256, bf16)."""
    if name == "imc_eval":
        g = _gen(cuda, 0)
        designs = torch.stack(list(space.decode(torch.rand((8, 40, space.N_GENES), generator=g,
                                                           device=cuda))), dim=-1)
        feats = ws.feats[None].expand(8, -1, -1, -1).to(cuda).contiguous()
        mask = ws.mask[None].expand(8, -1, -1).to(cuda).contiguous()
        return op_cases.op_args(name, (designs, feats, mask), {})
    if name == "ga_gen_step":
        ctx, pop, scores, u = _b2_case(cuda, ws, 40, [[0, 1, 2, 3]] * 8, 0)
        return op_cases.op_args(name, (pop, scores, u[0], ctx), {})
    if name == "flash_attention":
        args, kw = op_cases.flash_attention(Sq=128, Skv=128, H=32, KV=8, D=64)
    else:
        args, kw = op_cases.ssd_scan(S=256, H=48, P=64, N=128, dtype=torch.bfloat16, chunk=128)
    return op_cases.op_args(name, op_cases.to(args, cuda), kw)


@pytest.mark.parametrize("name", ["imc_eval", "ga_gen_step", "flash_attention", "ssd_scan"])
def test_operators_pass_opcheck(cuda, ws, name):
    """``torch.library.opcheck``: the schema (nothing mutated, no output
    aliasing an input), the autograd registration, the fake implementation
    against the CUDA one (shapes, dtypes, strides, devices) and a trace
    under AOT dispatch with dynamic shapes."""
    args = _opcheck_args(name, cuda, ws)
    torch.library.opcheck(op_cases.OPS[name],
                          [list(a) if isinstance(a, tuple) else a for a in args])


@pytest.mark.parametrize("case", sorted(op_cases.CASES))
def test_fake_agrees_with_the_card(cuda, case):
    """At every small case of ``tests/test_torch_ops.py`` (B3's D=36 pads
    for TMA) the CUDA implementation's outputs have the shapes, dtypes and
    strides its fake implementation gives, and the wrapper counts one
    launch a call."""
    from repro_torch.launch.dryrun import _device_caches_kept, fake_mode

    name = op_cases.kernel(case)
    args, kwargs = op_cases.CASES[case]()
    real = op_cases.OPS[name](*op_cases.op_args(name, op_cases.to(args, cuda), kwargs))
    with _device_caches_kept(), fake_mode():
        fake = op_cases.OPS[name](*op_cases.op_args(name, op_cases.to(args, "cuda"), kwargs))
    for r, f in zip(real if isinstance(real, tuple) else [real],
                    fake if isinstance(fake, tuple) else [fake], strict=True):
        assert (r.shape, r.dtype, r.stride(), r.device) == (f.shape, f.dtype, f.stride(),
                                                             f.device)
    wrapper = op_cases.WRAPPERS[name]
    before = wrapper.launches
    wrapper(*op_cases.to(args, cuda), **kwargs)
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("case", sorted(op_cases.MALFORMED))
def test_cuda_implementation_raises_the_wrappers_error(cuda, case):
    """The C++ CUDA implementation refuses each malformed call with the
    message of the wrapper (and of the fake implementation), word for
    word, through the wrapper and called directly."""
    name, args, kwargs, msg = op_cases.malformed(case)
    args, kwargs = op_cases.to(args, cuda), op_cases.to(kwargs, cuda)
    with pytest.raises(ValueError, match=msg):
        op_cases.WRAPPERS[name](*args, **kwargs)
    with pytest.raises(ValueError, match=msg):
        op_cases.OPS[name](*op_cases.op_args(name, args, kwargs))
