"""The port's cells, shape set and roofline (``configs/base.py``,
``launch/cells.py``, ``analysis/roofline.py``) against the JAX package's,
on the CPU.

* ``all_cells`` / ``skipped_cells``: the JAX package's names and reasons
  exactly, 33 + 7 = 40, the long runners {mamba2, jamba, mixtral}.
* For every cell, ``input_specs`` shapes equal the JAX ``input_specs``
  (the JAX package's int32 tokens and positions are the port's int64).
* For every config, ``abstract_params`` / ``abstract_opt_state`` shapes
  and dtypes equal the JAX ones leaf for leaf, in ``jax.tree`` order, and
  ``abstract_cache`` for every cell; no storage (``meta``).
* ``model_flops`` and ``active_param_count`` equal the JAX values for every
  cell (rel 1e-12).
* ``roofline_terms`` picks the bottleneck as
  ``tests/test_system.py::test_roofline_bottleneck_selection`` does, with
  the H100's constants.
* ``build_step`` without a mesh gives plain meta arguments, and on a 1x1
  mesh (a fake world of one) DTensors over meta shards whose placements
  are the bundle's.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.roofline import model_flops as jmodel_flops
from repro.configs.base import SHAPES_BY_NAME as JSHAPES
from repro.configs.base import get_config as jget
from repro.launch import cells as jcells
from repro_torch.analysis import roofline as troof
from repro_torch.analysis.census import CollectiveStats
from repro_torch.configs.base import ALL_SHAPES, SHAPES_BY_NAME, ShapeSpec, get_config, \
    list_configs
from repro_torch.launch import cells as tcells
from repro_torch.models.common import tree_flatten

CELLS = [c.name for c in tcells.all_cells()]
_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16, jnp.int32: torch.int32}


def _jdtype(d) -> torch.dtype:
    return _DTYPES[jnp.dtype(d).type]


def _cell(name):
    arch, shape = name.split("/")
    return get_config(arch), SHAPES_BY_NAME[shape], jget(arch), JSHAPES[shape]


def test_shape_set_matches_reference():
    assert [(s.name, s.seq_len, s.global_batch, s.kind) for s in ALL_SHAPES] == [
        (s.name, s.seq_len, s.global_batch, s.kind) for s in JSHAPES.values()]


def test_cells_and_skips_match_reference():
    got = [c.name for c in tcells.all_cells()]
    assert got == [c.name for c in jcells.all_cells()]
    assert tcells.skipped_cells() == jcells.skipped_cells()
    assert len(got) == 33 and len(tcells.skipped_cells()) == 7
    assert {c.cfg.name for c in tcells.all_cells() if c.shape.name == "long_500k"} == {
        "mamba2-780m", "jamba-v0.1-52b", "mixtral-8x7b"}
    for name in list_configs():
        cfg, jcfg = get_config(name), jget(name)
        assert cfg.supports_long_context == jcfg.supports_long_context
        assert [s.name for s in cfg.supported_shapes()] == [s.name for s in
                                                           jcfg.supported_shapes()]
        assert cfg.shape_skips() == jcfg.shape_skips()
    assert [c.name for c in tcells.all_cells("mixtral-8x7b", "long_500k")] == [
        "mixtral-8x7b/long_500k"]


@pytest.mark.parametrize("name", CELLS)
def test_input_specs_match_reference(name):
    cfg, shape, jcfg, jshape = _cell(name)
    got, want = tcells.input_specs(cfg, shape), jcells.input_specs(jcfg, jshape)
    assert list(got) == list(want)
    for k, (shp, dtype) in got.items():
        assert shp == tuple(want[k].shape), k
        jd = jnp.dtype(want[k].dtype)
        assert dtype == (torch.int64 if jd == jnp.int32 else _jdtype(jd)), k


@pytest.mark.parametrize("arch", list_configs())
def test_abstract_state_matches_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for got, want in ((tcells.abstract_params(cfg), jcells.abstract_params(jcfg)),
                      (tcells.abstract_opt_state(cfg), jcells.abstract_opt_state(jcfg))):
        g, w = tree_flatten(got)[0], jax.tree.leaves(want)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.device.type == "meta"
            assert tuple(a.shape) == tuple(b.shape) and a.dtype == _jdtype(b.dtype)
    for shape in cfg.supported_shapes():
        g = tree_flatten(tcells.abstract_cache(cfg, shape))[0]
        w = jax.tree.leaves(jcells.abstract_cache(jcfg, JSHAPES[shape.name]))
        assert [(tuple(a.shape), a.dtype) for a in g] == [
            (tuple(b.shape), _jdtype(b.dtype)) for b in w], shape.name
        assert all(a.device.type == "meta" for a in g)


@pytest.mark.parametrize("name", CELLS)
def test_model_flops_and_active_params_match_reference(name):
    cfg, shape, jcfg, jshape = _cell(name)
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert troof.model_flops(cfg, shape) == pytest.approx(jmodel_flops(jcfg, jshape), rel=1e-12)


def test_roofline_bottleneck_selection():
    rf = troof.roofline_terms(
        cell="x", mesh_name="m", chips=256, flops=1e12, bytes_accessed=1e9,
        coll=CollectiveStats(total_bytes=10**12, by_kind={}, counts={}),
        model_flops_global=2.56e14)
    assert rf.bottleneck == "collective"
    assert rf.t_collective == pytest.approx(1e12 / 450e9)
    assert rf.t_compute == pytest.approx(1e12 / 989e12)
    assert rf.t_memory == pytest.approx(1e9 / 3.35e12)
    assert rf.useful_ratio == pytest.approx(1.0)
    rf = troof.roofline_terms(
        cell="x", mesh_name="m", chips=1, flops=1e15, bytes_accessed=1e9,
        coll=CollectiveStats(total_bytes=0, by_kind={}, counts={}), model_flops_global=5e14)
    assert rf.bottleneck == "compute" and rf.peak_fraction == 1.0
    assert rf.useful_ratio == pytest.approx(0.5)


def test_build_step_abstract_arguments():
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import fake_world, make_test_mesh

    cfg = get_config("llama3.2-1b").reduced()
    shape = ShapeSpec("t", 64, 2, "decode")
    plain = tcells.build_step(cfg, shape, None)
    assert plain.mesh is None and plain.updates_in_place == (1,)
    assert all(t.device.type == "meta" and not isinstance(t, DTensor)
               for t in tree_flatten(plain.args)[0])
    with fake_world(1, "cpu"):
        mesh = make_test_mesh(1, 1, device_type="cpu")
        b = tcells.build_step(cfg, shape, mesh)
        leaves = tree_flatten(b.args)[0]
        assert all(isinstance(t, DTensor) and t.to_local().device.type == "meta" for t in leaves)
        got = [tuple(t.shape) for t in leaves]
    assert got == [tuple(t.shape) for t in tree_flatten(plain.args)[0]]
    assert tcells.build_step(cfg, ShapeSpec("t", 64, 2, "train"), None).updates_in_place == (0, 1)
    with pytest.raises(ValueError, match="kind"):
        tcells.input_specs(cfg, ShapeSpec("s", 8, 1, "score"))


def test_make_inputs_follow_the_specs():
    cfg = get_config("qwen2-vl-2b").reduced()
    for kind in ("train", "prefill", "decode"):
        shape = ShapeSpec("t", 24, 2, kind)
        got = tcells.make_inputs(cfg, shape, torch.Generator().manual_seed(0))
        for k, (shp, dtype) in tcells.input_specs(cfg, shape).items():
            assert tuple(got[k].shape) == shp and got[k].dtype == dtype
        if kind == "decode":
            assert torch.equal(got["pos"], torch.full((2,), 23))
    assert np.all(got["token"].numpy() < 1000)
