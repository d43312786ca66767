"""The port's sharding rules (``distributed/sharding.py``, ``distributed/ctx.py``,
``models.common.param_specs``) and int8 compression
(``distributed/compression.py``) against the JAX package's, on the CPU.

* ``param_specs`` of every configuration's template equals the JAX
  package's on the rule layouts 16x16, 4x4, 2x2, 1x4 and 2x16x16 (with
  ``pod``): qwen3's expert-parallel layout and mixtral's expert-TP fallback
  included.  Specs compare as plain tuples, one-name tuples normalised
  (jax 0.9.0's ``PartitionSpec`` stores ``("data",)`` as ``"data"``).
* ``input_sharding`` and ``cache_spec`` equal the JAX functions on the
  layout set of ``tests/test_torch_mesh.py`` (a ``MeshLayout`` stand-in for
  the port, a names-and-shape stand-in for jax's ``Mesh``).
* ``compress`` gives the JAX ``compress``'s int8 payload and scales bit for
  bit and its error-feedback residual within 1e-7.  ``psum_compressed``
  over gloo worlds is held in ``tests/test_torch_mesh_train.py``.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import ShapeSpec as JShape
from repro.configs.base import get_config as jget
from repro.distributed import compression as jcomp
from repro.distributed import ctx as jctx
from repro.distributed import sharding as jsh
from repro.models import transformer as jt
from repro.models.common import param_specs as jparam_specs
from repro_torch.configs.base import ShapeSpec, get_config, list_configs
from repro_torch.core.distributed import MeshLayout
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import ctx as tctx
from repro_torch.distributed import sharding as tsh
from repro_torch.models import transformer as tt
from repro_torch.models.common import ParamDecl, param_structs, tree_leaves

RULE_LAYOUTS = [((16, 16), ("data", "model")), ((4, 4), ("data", "model")),
                ((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
                ((2, 16, 16), ("pod", "data", "model"))]
# tests/test_torch_mesh.py's layout set
LAYOUTS = [((1, 1), ("search", "data")), ((2, 1), ("search", "data")),
           ((1, 2), ("search", "data")), ((2, 2), ("search", "data")),
           ((4, 2), ("search", "data")), ((2, 4), ("search", "data")),
           ((8, 1), ("search", "data")), ((3, 1), ("search", "data")),
           ((2, 2), ("data", "model")), ((4,), ("model",)), ((2, 3), ("search", "model")),
           ((2, 2, 2), ("pod", "data", "model")), ((2, 2, 2), ("search", "data", "model"))]
SHAPE_CELLS = [("train_b8", 64, 8, "train"), ("prefill_b3", 48, 3, "prefill"),
               ("decode_b32", 64, 32, "decode"), ("long_b1", 128, 1, "decode"),
               ("train_b1", 32, 1, "train")]


def _norm(spec):
    return tuple(None if p is None else ((p,) if isinstance(p, str) else tuple(p))
                 for p in spec)


def _jax_mesh(sizes, names):
    """What the JAX layout functions read of a mesh: its axis names and
    the shape of its device grid."""
    return types.SimpleNamespace(axis_names=tuple(names), devices=np.empty(sizes))


def _spec_leaves(tree) -> list:
    out = []

    def walk(t):
        if isinstance(t, tuple):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            for x in t:
                walk(x)

    walk(tree)
    return out


@pytest.mark.parametrize("name", list_configs())
@pytest.mark.parametrize("sizes,names", RULE_LAYOUTS, ids=lambda v: "x".join(map(str, v)))
def test_param_specs_equal_the_reference(sizes, names, name):
    ref = jax.tree.leaves(jparam_specs(jt.param_template(jget(name)),
                                       jsh.make_rules(_jax_mesh(sizes, names))),
                          is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    got = _spec_leaves(tsh.spec_tree(tt.param_template(get_config(name)),
                                     MeshLayout(names, sizes)))
    assert len(got) == len(ref)
    assert [_norm(s) for s in got] == [_norm(s) for s in ref]


def test_expert_layouts_and_placements():
    """qwen3 (128 experts) takes the EP layout on a 16-way model axis,
    mixtral (8) the expert-TP fallback; placements follow the specs."""
    mesh = MeshLayout(("data", "model"), (16, 16))
    qwen = tsh.spec_tree(tt.param_template(get_config("qwen3-moe-235b-a22b")), mesh)
    mix = tsh.spec_tree(tt.param_template(get_config("mixtral-8x7b")), mesh)
    assert qwen["blocks"][0]["ffn"]["w_gate"] == (None, "model", None, "data")
    assert mix["blocks"][0]["ffn"]["w_gate"] == (None, None, "data", "model")
    places = tsh.params_sharding(None, mesh, tt.param_template(get_config("mixtral-8x7b")))
    assert places["blocks"][0]["ffn"]["w_gate"] == (Shard(2), Shard(3))
    assert places["final_norm"] == (Shard(0), Replicate())
    assert places["embed"] == (Shard(1), Shard(0))


@pytest.mark.parametrize("sizes,names", LAYOUTS, ids=lambda v: "x".join(map(str, v)))
def test_input_sharding_and_cache_spec_equal_the_reference(sizes, names):
    ref_mesh, mine = _jax_mesh(sizes, names), MeshLayout(names, sizes)
    assert tsh.batch_axes(mine) == jsh.batch_axes(ref_mesh)
    for name in list_configs():
        jcfg, tcfg = jget(name), get_config(name)
        for cell in SHAPE_CELLS:
            js, ts = JShape(*cell), ShapeSpec(*cell)
            ref = jsh.input_sharding(jcfg, js, ref_mesh)
            got = tsh.input_sharding(tcfg, ts, mine)
            assert {k: _norm(v) for k, v in got.items()} == {k: _norm(v) for k, v in ref.items()}
            jr, tr = jcfg.reduced(), tcfg.reduced()
            for seq_axis in ("model", None):
                ref_c = jax.tree.leaves(
                    jsh.cache_spec(jr, js, ref_mesh, seq_axis=seq_axis),
                    is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
                got_c = tsh.cache_spec(tr, ts, mine, seq_axis=seq_axis)
                assert [_norm(s[k]) for s in got_c for k in sorted(s)] == [
                    _norm(s) for s in ref_c]


@pytest.mark.parametrize("sizes,names", RULE_LAYOUTS, ids=lambda v: "x".join(map(str, v)))
def test_logical_sizes_and_constrain_outside_a_context(sizes, names):
    """``constrain`` returns its argument itself outside a context;
    ``logical_axis_size`` and ``axis_product`` read the rules as the JAX
    package's; ``logical_spec`` falls back per dim."""
    x = torch.ones(4, 6)
    assert tctx.constrain(x, ("batch", None)) is x
    assert tctx.logical_axis_size("experts") == 1
    ref_mesh, mine = _jax_mesh(sizes, names), MeshLayout(names, sizes)
    jr, tr = jsh.make_rules(ref_mesh), tsh.make_rules(mine)
    with jctx.use_rules(ref_mesh, jr), tctx.use_rules(mine, tr):
        for name in ("experts", "batch", "heads", "embed", "layers", "seq", "vocab"):
            assert tctx.logical_axis_size(name) == jctx.logical_axis_size(name)
        for ax in (None, "data", ("pod", "data"), ("data", "model"), "search"):
            assert tctx.axis_product(mine, ax) == jctx.axis_product(ref_mesh, ax)
        n = tctx.axis_product(mine, "model")
        spec = tctx.logical_spec(mine, tr, (8, 3 * n + 1, 4 * n),
                                 ("batch", "heads", "heads"))
        assert spec[1] is None and spec[2] == ("model" if n > 1 else None)
    assert tctx.constrain(x, ("batch", None)) is x


def test_the_context_holds_on_other_threads():
    """A CUDA backward (and so a remat'd block's recomputation) runs on the
    autograd engine's own thread: it must see the launcher's rules."""
    import threading

    mine = MeshLayout(("data", "model"), (2, 4))
    seen = []
    with tctx.use_rules(mine, tsh.make_rules(mine)):
        t = threading.Thread(target=lambda: seen.append(tctx.logical_axis_size("experts")))
        t.start()
        t.join()
    t = threading.Thread(target=lambda: seen.append(tctx.logical_axis_size("experts")))
    t.start()
    t.join()
    assert seen == [4, 1]


def test_param_structs_are_meta_tensors():
    tmpl = tt.param_template(get_config("llama3.2-1b"))
    structs = tree_leaves(param_structs(tmpl))
    decls = []

    def walk(t):
        if isinstance(t, ParamDecl):
            decls.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            for v in t:
                walk(v)

    walk(tmpl)
    assert [tuple(s.shape) for s in structs] == [d.shape for d in decls]
    assert all(s.device.type == "meta" and s.dtype == torch.float32 for s in structs)
    with pytest.raises(AssertionError):
        ParamDecl((2, 3), ("embed",))


def _grad_tree(seed):
    r = np.random.default_rng(seed)
    return {"a": (r.standard_normal((5, 7)) * 3).astype(np.float32),
            "b": [r.standard_normal(11).astype(np.float32) * 1e-3,
                  np.zeros((2, 3), np.float32)],
            "c": (r.standard_normal((4, 4)) * 50).astype(np.float32)}


def test_compress_equals_the_reference():
    """int8 payload and scales bit for bit, the residual within 1e-7, and
    decompress of both packages' payloads alike; twice, the second time
    with the first call's residual fed back."""
    g = _grad_tree(0)
    jef = jcomp.ef_init(g)
    tef = tcomp.ef_init(jax.tree.map(torch.from_numpy, g))
    for _ in range(2):
        jc, jef = jcomp.compress(g, jef)
        tc, tef = tcomp.compress(jax.tree.map(torch.from_numpy, g), tef)
        for a, b in zip(tree_leaves(tc.q), jax.tree.leaves(jc.q)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(tc.scale), jax.tree.leaves(jc.scale)):
            assert a.numpy().tobytes() == np.asarray(b, np.float32).tobytes()
        for a, b in zip(tree_leaves(tef), jax.tree.leaves(jef)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-7)
        for a, b in zip(tree_leaves(tcomp.decompress(tc)), jax.tree.leaves(jcomp.decompress(jc))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        jef = jax.tree.map(jnp.asarray, jef)
