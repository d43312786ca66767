"""Port parity for the JAX package's public names that the port took over
last: ``make_eval_fn``, the drivers' ``fused`` / ``pipelined``,
``evaluate_designs_kernel``, ``Roofline.table_row``, ``template_structs``,
``layer_norm``, ``objectives.INF``, the package re-exports and the serve
demo, each against the JAX function on the CPU.

Scores are held at rtol 1e-5 (float sums in another order, FMA
contraction in XLA), with the same entries infeasible (+inf) on both
sides; whole threefry runs at P=16, G=4 as ``tests/test_torch_prng.py``
holds them.  ``layer_norm`` is held within 1e-5 in float32 and within one
bf16 ulp of the output's magnitude (2^-7 relative) in bf16, where the
frameworks' rsqrt may round the last bit apart.
"""
from __future__ import annotations

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as rroofline
from repro.configs.base import get_config as rget_config
from repro.core import engine as rengine
from repro.core import objectives as robjectives
from repro.core import search as rsearch
from repro.core import space as rspace
from repro.kernels.imc_eval import ops as rops
from repro.models import common as rcommon
from repro.models import transformer as rtransformer
from repro.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert
from repro_torch.analysis import roofline
from repro_torch.configs.base import get_config
from repro_torch.core import engine, objectives, search, space
from repro_torch.examples import serve_demo
from repro_torch.imc import cost
from repro_torch.kernels.imc_eval import ops
from repro_torch.kernels.imc_eval.ops import imc_eval_multi
from repro_torch.models import common, transformer
from repro_torch.models.common import tree_flatten

RTOL = 1e-5
TF = dict(device="cpu", prng="threefry")
P, G = 16, 4


@pytest.fixture(scope="module")
def pair():
    r = rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])
    return r, convert.workload_set_from_arrays(r.names, r.feats, r.mask)


def _genomes(n, seed):
    return np.random.default_rng(seed).random((n, space.N_GENES), dtype=np.float32)


def _scores_close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=RTOL, atol=0)


# ------------------------------------------------------------ make_eval_fn
@pytest.mark.parametrize("backend,ref_backend", [("dense", "jnp"), ("table", "table")])
@pytest.mark.parametrize("objective", ["ela", "edp"])
def test_make_eval_fn_matches_reference(pair, backend, ref_backend, objective):
    """The paper's four CNNs, P=40 genomes: 24 seeded to fit the largest
    CNN, 16 uniform (mostly infeasible), under a generous area."""
    ws_r, ws = pair
    seeded = np.asarray(rengine.seed_population(jax.random.PRNGKey(42), ws_r, 24))
    g = np.concatenate([seeded, _genomes(16, 11)])
    fn = engine.make_eval_fn(ws, objective, 1e4, backend=backend, device="cpu")
    fn_r = rengine.make_eval_fn(ws_r, objective, 1e4, backend=ref_backend)
    s = fn(torch.from_numpy(g))
    assert s.shape == (40,) and s.dtype == torch.float32
    assert np.isfinite(s.numpy()).sum() > 10
    _scores_close(s, fn_r(jnp.asarray(g)))


def test_make_eval_fn_kernel_is_the_plain_path_on_the_cpu(pair):
    """On CPU tensors the kernel backend runs the imc_eval plain version
    (no launch) and scores as the dense backend does."""
    _, ws = pair
    g = _genomes(40, 12)
    before = imc_eval_multi.launches
    k = engine.make_eval_fn(ws, "ela", 150.0, backend="kernel", device="cpu")(g)
    d = engine.make_eval_fn(ws, "ela", 150.0, backend="dense", device="cpu")(g)
    assert imc_eval_multi.launches == before
    _scores_close(k, d)


def test_make_eval_fn_is_reexported_and_refuses_what_it_cannot_score(pair):
    _, ws = pair
    assert search.make_eval_fn is engine.make_eval_fn
    assert rsearch.make_eval_fn is rengine.make_eval_fn
    with pytest.raises(ValueError, match="backend"):
        engine.make_eval_fn(ws, "ela", 150.0, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="objective"):
        engine.make_eval_fn(ws, "pareto", 150.0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            engine.make_eval_fn(ws, "ela", 150.0)


# ------------------------------------------------- the drivers' switches
@pytest.fixture(scope="module")
def pipelined_refs(pair):
    ws_r, _ = pair
    return {b: rsearch.run_search(jax.random.PRNGKey(3), ws_r, pop_size=P, generations=G,
                                  backend=b, pipelined=True)
            for b in ("table", "jnp")}


@pytest.mark.parametrize("backend,ref_backend", [("table", "table"), ("dense", "jnp")])
def test_pipelined_run_search_matches_reference(pair, pipelined_refs, backend, ref_backend):
    """``pipelined=True`` on the threefry streams against the JAX
    package's: top scores at rtol 1e-5, ``ga is None`` in both, and the
    unpinned port run's fields bit for bit."""
    _, ws = pair
    ref = pipelined_refs[ref_backend]
    key = np.asarray(jax.random.PRNGKey(3))
    res = search.run_search(0, ws, pop_size=P, generations=G, backend=backend, key=key,
                            pipelined=True, **TF)
    assert res.ga is None and ref.ga is None
    assert res.top_designs == ref.top_designs
    np.testing.assert_allclose(res.top_scores, np.asarray(ref.top_scores), rtol=RTOL, atol=0)
    plain = search.run_search(0, ws, pop_size=P, generations=G, backend=backend, key=key,
                              **TF)
    assert plain.ga is not None
    np.testing.assert_array_equal(res.top_genomes, plain.top_genomes)
    np.testing.assert_array_equal(res.top_scores, plain.top_scores)
    np.testing.assert_array_equal(res.convergence, plain.convergence)
    assert res.top_designs == plain.top_designs and res.valid == plain.valid


def test_driver_engine_follows_the_jax_rule(pair):
    """An explicit engine governs; otherwise the shared engine of the
    device, stream and ``pipelined``, so a pinned call reuses a warm engine
    (``fused`` has no effect and picks none)."""
    _, ws = pair
    shared = engine.default_engine("cpu", "threefry")
    assert search._engine(None, "cpu", "threefry") is shared
    assert search._engine(None, "cpu", "threefry", pipelined=False) is shared
    own = search._engine(None, "cpu", "threefry", pipelined=True)
    assert own is not shared and own is engine.default_engine("cpu", "threefry", True)
    assert own.pipelined and own.prng == "threefry" and own.device == torch.device("cpu")
    assert search._engine(None, "cpu", "threefry", pipelined=True) is own
    mine = engine.SearchEngine(device="cpu", prng="threefry")
    assert search._engine(mine, "cpu", "threefry", pipelined=True) is mine
    # through **kw: separate_search's batched path and the joint alias
    sep = search.separate_search(0, ws.subset([0, 2]), pop_size=8, generations=2,
                                 pipelined=True, fused=False, **TF)
    assert all(r.ga is None for r in sep.values())
    assert search.joint_search(0, ws, pop_size=8, generations=2, pipelined=True,
                               **TF).ga is None


def test_batched_search_pipelined_equals_unpinned(pair):
    _, ws = pair
    a = search.joint_search_batched([0, 1], ws, pop_size=8, generations=2, pipelined=True,
                                    **TF)
    b = search.joint_search_batched([0, 1], ws, pop_size=8, generations=2, **TF)
    for x, y in zip(a, b):
        assert x.ga is None and y.ga is not None
        np.testing.assert_array_equal(x.top_scores, y.top_scores)
        np.testing.assert_array_equal(x.top_genomes, y.top_genomes)


# ------------------------------------------------- evaluate_designs_kernel
def test_evaluate_designs_kernel_matches_reference(pair):
    """The ``WorkloadSet`` form: the ``_arrays`` call's bits, the JAX
    function on its ``jnp`` backend at rtol 1e-5."""
    ws_r, ws = pair
    g = _genomes(40, 13)
    d, dr = space.decode(torch.from_numpy(g)), rspace.decode(jnp.asarray(g))
    r = ops.evaluate_designs_kernel(d, ws)
    ra = ops.evaluate_designs_kernel_arrays(d, ws.feats, ws.mask)
    for f in r._fields:
        assert torch.equal(getattr(r, f), getattr(ra, f)), f
    rr = rops.evaluate_designs_kernel(dr, ws_r, backend="jnp")
    for f in ("energy_pj", "latency_ns", "area_mm2", "util"):
        np.testing.assert_allclose(getattr(r, f).numpy(), np.asarray(getattr(rr, f)),
                                   rtol=RTOL, atol=0)
    np.testing.assert_array_equal(r.fits.numpy(), np.asarray(rr.fits))
    np.testing.assert_array_equal(r.valid.numpy(), np.asarray(rr.valid))
    rd = cost.evaluate_designs(d, ws)
    for f in ("energy_pj", "latency_ns"):
        np.testing.assert_allclose(getattr(r, f).numpy(), getattr(rd, f).numpy(),
                                   rtol=RTOL, atol=0)


# ------------------------------------------------------- the small helpers
def test_roofline_table_row_is_the_jax_string():
    fields = dict(cell="llama3.2-1b/decode_32k", mesh="data=16xmodel=16", chips=256,
                  flops_per_device=1.25e12, bytes_per_device=3.5e9,
                  collective_bytes=2.0e8, t_compute=0.0123456, t_memory=0.00456,
                  t_collective=0.000789, bottleneck="compute", model_flops_global=2.5e14,
                  useful_ratio=0.8765, peak_fraction=0.98765)
    row = roofline.Roofline(**fields).table_row()
    assert row == rroofline.Roofline(**fields).table_row()
    assert row == ("| llama3.2-1b/decode_32k | data=16xmodel=16 | 12.35 | 4.56 | 0.79 | "
                   "compute | 0.88 | 98.77% |")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b", "mamba2-780m",
                                  "whisper-medium"])
def test_template_structs_have_the_jax_leaves(arch):
    cfg, cfg_r = get_config(arch).reduced(), rget_config(arch).reduced()
    leaves = tree_flatten(transformer.template_structs(cfg))[0]
    ref = jax.tree.leaves(rtransformer.template_structs(cfg_r))
    assert [tuple(t.shape) for t in leaves] == [tuple(s.shape) for s in ref]
    assert all(t.device.type == "meta" and t.dtype == torch.float32 for t in leaves)
    bf16 = tree_flatten(transformer.template_structs(cfg, torch.bfloat16))[0]
    assert all(t.dtype == torch.bfloat16 for t in bf16)


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
def test_layer_norm_matches_reference(dtype, jdtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 7, 64)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    y = common.layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    yr = rcommon.layer_norm(jnp.asarray(x).astype(jdtype), jnp.asarray(w), jnp.asarray(b),
                            1e-5)
    assert y.dtype == dtype and tuple(y.shape) == x.shape
    a, r = y.float().numpy(), np.asarray(yr.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(a, r, rtol=0, atol=1e-5)
    else:
        assert np.all(np.abs(a - r) <= 2.0 ** -7 * np.maximum(np.abs(r), 1.0))


def test_inf_is_the_score_of_an_infeasible_design(pair):
    _, ws = pair
    assert objectives.INF == float(robjectives.INF) == float("inf")
    r = cost.evaluate_designs(space.decode(torch.from_numpy(_genomes(40, 14))), ws)
    s = objectives.make_objective("ela", 1e-9)(r)  # no design fits 1e-9 mm^2
    assert torch.all(s == objectives.INF)


@pytest.mark.parametrize("module", ["core", "imc", "workloads", "serve", "distributed",
                                    "configs", "checkpoint"])
def test_package_exports_resolve(module):
    """Every name a package of the port exports resolves, and names the
    object of its defining module (``repro_torch.core`` loads its names on
    first use)."""
    mod = importlib.import_module(f"repro_torch.{module}")
    names = getattr(mod, "__all__", None) or [n for n in vars(mod) if not n.startswith("_")]
    for n in names:
        assert getattr(mod, n) is not None, n
    if module == "core":
        assert mod.run_search is search.run_search and mod.space is space
        assert mod.SearchEngine is engine.SearchEngine
        with pytest.raises(AttributeError):
            mod.no_such_name
    if module == "serve":
        from repro_torch.serve import dse

        assert mod.DSEService is dse.DSEService


# ----------------------------------------------------------- the serve demo
def test_serve_demo_serves_every_request_its_full_max_new(capsys):
    """The reduced mixtral burst on the CPU: the JAX demo's draws, every
    request its ``max_new`` tokens."""
    reqs = serve_demo.burst(get_config("mixtral-8x7b").reduced(), 3)
    vocab = rget_config("mixtral-8x7b").reduced().vocab_size
    rng = np.random.default_rng(0)
    for r in reqs:  # examples/serve_demo.py's draws, in its order
        plen = int(rng.integers(4, 24))
        np.testing.assert_array_equal(
            r.prompt, rng.integers(0, vocab, size=plen).astype(np.int32))
        assert r.max_new == int(rng.integers(8, 24))
    assert serve_demo.main(["--device", "cpu", "--requests", "3"]) == 0
    out = capsys.readouterr().out
    m = re.search(r"served (\d+) requests, (\d+) tokens in \S+s \(\S+ tok/s on cpu\)", out)
    assert m and int(m.group(1)) == 3
    assert int(m.group(2)) == sum(r.max_new for r in reqs)
    got = {int(a): (int(b), int(c))
           for a, b, c in re.findall(r"req (\d+): prompt +(\d+) -> +(\d+) new", out)}
    assert got == {r.rid: (len(r.prompt), r.max_new) for r in reqs}
