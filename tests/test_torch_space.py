"""Port parity: technology constants, workloads, packing and the search
space of ``repro_torch`` against the JAX package, bit-exact.

Data passes between the packages as numpy arrays; the port runs on the
CPU (``device="cpu"``)."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import space as rspace
from repro.imc.tech import TECH as RTECH
from repro.workloads import cnn as rcnn
from repro.workloads.pack import pack_workloads as rpack
from repro_torch import convert
from repro_torch.core import space
from repro_torch.imc.tech import TECH, TechParams
from repro_torch.workloads import cnn
from repro_torch.workloads.pack import pack_workloads


@pytest.fixture(scope="module")
def pair():
    ref = rpack([(n, rcnn.cnn_workload(n)) for n in rcnn.PAPER_WORKLOADS])
    port = pack_workloads([(n, cnn.cnn_workload(n)) for n in cnn.PAPER_WORKLOADS])
    return ref, port


def test_tech_fields_match_reference():
    assert TechParams._fields == type(RTECH)._fields
    for f in TechParams._fields:
        assert getattr(TECH, f) == getattr(RTECH, f), f
    assert TECH.g_avg_s == RTECH.g_avg_s
    assert TECH.cell_area_mm2 == RTECH.cell_area_mm2
    for v in (0.7, 0.9, 1.175):
        assert TECH.t_min_ns(v) == RTECH.t_min_ns(v)
    assert hash(TECH) == hash(TechParams())
    assert convert.tech_from_dict(RTECH._asdict()) == TECH


def test_tech_from_dict_rejects_unknown_fields():
    with pytest.raises(ValueError):
        convert.tech_from_dict({"no_such_field": 1.0})


def test_cnn_workloads_match_reference():
    assert tuple(cnn.PAPER_WORKLOADS) == tuple(rcnn.PAPER_WORKLOADS)
    for n in rcnn.PAPER_WORKLOADS:
        assert cnn.cnn_workload(n) == rcnn.cnn_workload(n)


def test_pack_and_fingerprint_match_reference(pair):
    ref, port = pair
    assert port.names == ref.names and port.n == ref.n
    assert port.feats.dtype == torch.float32 and port.mask.dtype == torch.bool
    np.testing.assert_array_equal(port.feats.numpy(), np.asarray(ref.feats))
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    assert port.fingerprint() == ref.fingerprint()
    conv = convert.workload_set_from_arrays(ref.names, ref.feats, ref.mask)
    assert conv.fingerprint() == ref.fingerprint()


def test_subset_matches_reference(pair):
    ref, port = pair
    for idx in ([0], [1, 3], [3, 2, 0]):
        assert port.subset(idx).fingerprint() == ref.subset(idx).fingerprint()


def test_space_tables_and_token_match_reference():
    assert space.FIELDS == rspace.FIELDS
    np.testing.assert_array_equal(space.GRID_SIZES, rspace.GRID_SIZES)
    assert space.SPACE_SIZE == rspace.SPACE_SIZE
    for f in space.FIELDS:
        np.testing.assert_array_equal(space.SPACE[f], rspace.SPACE[f])
    assert space.grid_token() == rspace.grid_token()


def test_configure_grid_token_matches_reference():
    try:
        space.configure_grid(2)
        rspace.configure_grid(2)
        assert space.grid_token() == rspace.grid_token()
        np.testing.assert_array_equal(space.GRID_SIZES, rspace.GRID_SIZES)
        g = np.random.default_rng(0).random((64, space.N_GENES), dtype=np.float32)
        np.testing.assert_array_equal(
            space.decode_indices(torch.from_numpy(g)).numpy(),
            np.asarray(rspace.decode_indices(jnp.asarray(g))))
    finally:
        space.configure_grid(1)
        rspace.configure_grid(1)
    assert space.grid_token() == rspace.grid_token()


def _edge_genomes():
    """Random genomes plus every cell boundary, just below it, 0 and the
    largest gene value."""
    rng = np.random.default_rng(1)
    rows = [rng.random((256, space.N_GENES), dtype=np.float32)]
    for j, n in enumerate(space.GRID_SIZES):
        k = np.arange(n + 1, dtype=np.float32) / np.float32(n)
        for v in (k, np.nextafter(k, np.float32(0))):
            g = np.full((len(v), space.N_GENES), 0.5, np.float32)
            g[:, j] = np.clip(v, 0.0, np.float32(1.0 - 1e-7))
            rows.append(g)
    return np.concatenate(rows)


def test_decode_bit_exact():
    g = _edge_genomes()
    idx = space.decode_indices(torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(idx, np.asarray(rspace.decode_indices(jnp.asarray(g))))
    np.testing.assert_array_equal(space.decode_indices_np(g),
                                  rspace.decode_indices_np(g))
    d = space.decode(torch.from_numpy(g))
    dr = rspace.decode(jnp.asarray(g))
    for f in space.FIELDS:
        np.testing.assert_array_equal(getattr(d, f).numpy(), np.asarray(getattr(dr, f)))


def test_decode_batched_matches_flat():
    g = torch.from_numpy(_edge_genomes()[:240].reshape(4, 60, space.N_GENES))
    flat = space.decode_indices(g.reshape(-1, space.N_GENES))
    assert torch.equal(space.decode_indices(g).reshape(-1, space.N_GENES), flat)


def test_index_helpers_match_reference():
    idx = space.decode_indices_np(_edge_genomes())
    np.testing.assert_array_equal(space.genome_from_indices(idx),
                                  rspace.genome_from_indices(idx))
    assert space.design_dicts_from_indices(idx[:50]) == \
        rspace.design_dicts_from_indices(idx[:50])
    d = space.designs_from_indices(torch.from_numpy(idx.astype(np.int64)))
    dr = rspace.designs_from_indices(jnp.asarray(idx))
    for f in space.FIELDS:
        np.testing.assert_array_equal(getattr(d, f).numpy(), np.asarray(getattr(dr, f)))


def test_random_genomes_shape_and_range():
    g = space.random_genomes(100, generator=torch.Generator().manual_seed(0))
    assert g.shape == (100, space.N_GENES) and g.dtype == torch.float32
    assert float(g.min()) >= 0.0 and float(g.max()) < 1.0
    _ = jax.device_count()  # both packages live in one process
