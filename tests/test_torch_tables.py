"""Port parity: the factorized grid tables against the JAX package's
``imc/tables.py`` and against the port's own dense path.

Tables and table-path metrics are held at rtol 1e-5 (float sums in
another order, FMA contraction in XLA); crossbar demand sums small
integers and is held exactly, as are fits and validity."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import space as rspace
from repro.imc import tables as rtables
from repro.workloads.cnn import PAPER_WORKLOADS, cnn_workload
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert
from repro_torch.core import space
from repro_torch.imc import cost, tables

RTOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    r = rpack([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])
    return r, convert.workload_set_from_arrays(r.names, r.feats, r.mask)


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=0)


def _genomes(n, seed):
    return np.random.default_rng(seed).random((n, space.N_GENES), dtype=np.float32)


def test_tables_match_reference(pair):
    ws_r, ws = pair
    t = tables.build_tables_arrays(ws.feats, ws.mask)
    tr = rtables.build_tables_arrays(ws_r.feats, ws_r.mask)
    for f in tables.WorkloadTables._fields:
        a, b = getattr(t, f), np.asarray(getattr(tr, f))
        assert tuple(a.shape) == b.shape, f
        _close(a, b)
    np.testing.assert_array_equal(t.demand.numpy(), np.asarray(tr.demand))


def test_tables_batched_match_single(pair):
    _, ws = pair
    subsets = [[0], [1, 2], [0, 1, 2, 3]]
    W, L = ws.n, ws.feats.shape[1]
    feats = torch.zeros((3, W, L, 6))
    mask = torch.zeros((3, W, L), dtype=torch.bool)
    for i, s in enumerate(subsets):
        sub = ws.subset(s)
        feats[i, : sub.n], mask[i, : sub.n] = sub.feats, sub.mask
    tb = tables.build_tables_batched(feats, mask)
    for i, s in enumerate(subsets):
        t1 = tables.build_tables_arrays(ws.subset(s).feats, ws.subset(s).mask)
        for f in tables.WorkloadTables._fields:
            assert torch.equal(getattr(tb, f)[i, : len(s)], getattr(t1, f)), f
            assert not getattr(tb, f)[i, len(s):].any()  # masked-out workloads


@pytest.mark.parametrize("seed", [0, 1])
def test_table_eval_matches_reference_on_same_tables(pair, seed):
    """Both packages fed the SAME tables (the reference's, carried across
    by ``convert.tables_from_arrays``)."""
    ws_r, _ = pair
    tr = rtables.build_tables_arrays(ws_r.feats, ws_r.mask)
    t = convert.tables_from_arrays(tr, device="cpu")
    g = _genomes(400, seed)
    r = tables.evaluate_genomes_tables(torch.from_numpy(g), t)
    rr = rtables.evaluate_genomes_tables(jnp.asarray(g), tr)
    for f in ("energy_pj", "latency_ns", "area_mm2", "util"):
        _close(getattr(r, f), getattr(rr, f))
    np.testing.assert_array_equal(r.fits.numpy(), np.asarray(rr.fits))
    np.testing.assert_array_equal(r.valid.numpy(), np.asarray(rr.valid))


def test_table_eval_matches_dense(pair):
    _, ws = pair
    t = tables.build_tables_arrays(ws.feats, ws.mask)
    g = torch.from_numpy(_genomes(400, 2))
    r = tables.evaluate_genomes_tables(g, t)
    rd = cost.evaluate_designs(space.decode(g), ws)
    for f in ("energy_pj", "latency_ns", "area_mm2", "util"):
        _close(getattr(r, f), getattr(rd, f))
    assert torch.equal(r.fits, rd.fits) and torch.equal(r.valid, rd.valid)


def test_table_eval_ragged_and_fully_masked():
    """A ragged layer mask and a fully-masked workload (zero tables: fits
    everywhere, zero energy and latency), as the reference's own test."""
    rng = np.random.default_rng(3)
    feats = (np.abs(rng.normal(size=(3, 9, 6))) * 100 + 1).astype(np.float32)
    feats[..., 5] = np.round(feats[..., 5])
    mask = np.zeros((3, 9), bool)
    mask[0, :9], mask[1, :4] = True, True
    t = tables.build_tables_arrays(torch.from_numpy(feats), torch.from_numpy(mask))
    tr = rtables.build_tables_arrays(jnp.asarray(feats), jnp.asarray(mask))
    for f in tables.WorkloadTables._fields:
        _close(getattr(t, f), getattr(tr, f))
    g = torch.from_numpy(_genomes(64, 4))
    r = tables.evaluate_genomes_tables(g, t)
    rd = cost.evaluate_designs_arrays(space.decode(g), torch.from_numpy(feats),
                                      torch.from_numpy(mask))
    _close(r.energy_pj[:, :2], rd.energy_pj[:, :2])
    assert bool(r.fits[:, 2].all())
    assert not r.latency_ns[:, 2].any() and not r.energy_pj[:, 2].any()


def test_table_eval_batched_matches_unbatched(pair):
    _, ws = pair
    t = tables.build_tables_arrays(ws.feats, ws.mask)
    tb = tables.WorkloadTables(*(x[None].expand(3, *x.shape) for x in t))
    g = torch.from_numpy(_genomes(90, 5).reshape(3, 30, space.N_GENES))
    rb = tables.evaluate_genomes_tables(g, tb)
    for b in range(3):
        r1 = tables.evaluate_genomes_tables(g[b], t)
        for f in r1._fields:
            assert torch.equal(getattr(rb, f)[b], getattr(r1, f)), f


def test_tables_on_densified_grid_match_reference(pair):
    ws_r, ws = pair
    try:
        space.configure_grid(2)
        rspace.configure_grid(2)
        t = tables.build_tables_arrays(ws.feats, ws.mask)
        tr = rtables.build_tables_arrays(ws_r.feats, ws_r.mask)
        for f in tables.WorkloadTables._fields:
            _close(getattr(t, f), getattr(tr, f))
        g = _genomes(128, 6)
        r = tables.evaluate_genomes_tables(torch.from_numpy(g), t)
        rr = rtables.evaluate_genomes_tables(jnp.asarray(g), tr)
        _close(r.energy_pj, rr.energy_pj)
        np.testing.assert_array_equal(r.valid.numpy(), np.asarray(rr.valid))
    finally:
        space.configure_grid(1)
        rspace.configure_grid(1)


def test_convert_rejects_wrong_leaf_count():
    with pytest.raises(ValueError):
        convert.tables_from_arrays([np.zeros(3)] * 2, device="cpu")
    with pytest.raises(ValueError):
        convert.ga_state_from_arrays(np.zeros((2, 4, 9)), np.zeros((2, 5)), device="cpu")


@pytest.mark.parametrize("density", [1, 2])
def test_table_bytes_and_grid_shape_match_reference(pair, density):
    """``table_bytes`` and ``grid_table_shape`` equal the JAX functions on
    the active grid, and the bytes grow with density (as
    ``tests/test_fused_gen.py`` holds for the reference)."""
    ws_r, ws = pair
    base = tables.table_bytes(ws.tables())
    try:
        space.configure_grid(density)
        rspace.configure_grid(density)
        assert tables.grid_table_shape() == rtables.grid_table_shape()
        t = ws.tables()
        assert tables.table_bytes(t) == rtables.table_bytes(ws_r.tables())
        assert tuple(t.demand.shape[-3:]) == tuple(
            tables.grid_table_shape()[f] for f in ("rows", "cols", "bits_cell"))
        assert tuple(t.spill.shape[-1:]) == (tables.grid_table_shape()["glb_mb"],)
        if density > 1:
            assert tables.table_bytes(t) > base
        else:
            assert tables.table_bytes(t) == base
    finally:
        space.configure_grid(1)
        rspace.configure_grid(1)
    assert tables.table_bytes(ws.tables()) == base


def test_table_bytes_counts_batched_leaves(pair):
    _, ws = pair
    t = ws.tables()
    tb = tables.build_tables_batched(ws.feats[None].expand(3, -1, -1, -1),
                                     ws.mask[None].expand(3, -1, -1))
    assert tables.table_bytes(tb) == 3 * tables.table_bytes(t)
