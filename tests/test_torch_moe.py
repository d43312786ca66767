"""The port's MoE layer and position encodings against the JAX package's,
on the CPU.

Same inputs (numpy, seeded) through both packages:

* ``moe_ffn`` at capacity factors 8.0 (nothing dropped), 1.25 (the
  configs' own) and 0.3 (most entries dropped), in float32 and bf16: the
  kept (token, k) entries are the same set (the reference's routing is
  ``src/repro/models/moe.py:48-63``, read here through the same jnp
  calls), the outputs agree within ``F32_TOL`` (float32: the two
  frameworks sum the expert products in another order) or ``BF16_TOL`` of
  the output's largest magnitude (bf16: the products and the gate weights
  round to bf16 in both, so an entry may land one bf16 ulp, 2^-8 of its
  scale, apart; twice that is allowed), and ``aux`` within 1e-6;
* ties: a zero router gives every expert the same probability; both
  packages must then choose experts 0..k-1 (``jax.lax.top_k`` puts the
  lower index first; ``torch.topk`` promises no order among ties);
* the JAX package's own two MoE tests (``tests/test_models.py``): tokens
  dropped at capacity change the output; with a uniform router top-1 and
  top-2 give the same output; ``with_aux=False`` (decode) changes no bit;
* ``apply_mrope`` with three different (t, h, w) position streams (equal
  streams would hide a section mix-up), ``mrope_sections``, and the
  sinusoid positions of the encoder and of a decode step, in float32,
  within 1e-5 (cos / sin / exp differ by a float32 ulp between the two).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe

F32_TOL = 1e-5
BF16_TOL = 2.0 ** -7


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _moe_inputs(seed, B=2, S=32, d=16, E=4, f=24):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    r = rng.standard_normal((d, E)).astype(np.float32)
    wg, wu = ((rng.standard_normal((E, d, f)) * 0.2).astype(np.float32) for _ in range(2))
    wd = (rng.standard_normal((E, f, d)) * 0.2).astype(np.float32)
    return x, r, wg, wu, wd


def _ref_keep(x, router, topk, capacity_factor):
    """The JAX package's routing (moe.py:48-63): each (token, k) entry's
    expert and whether it keeps its queue slot."""
    B, S, _ = x.shape
    E = router.shape[-1]
    C = jmoe.moe_capacity(S, E, topk, capacity_factor)
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), router.astype(jnp.float32))
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), topk)
    flat = jax.nn.one_hot(topi, E, dtype=jnp.int32).reshape(B, S * topk, E)
    pos = ((jnp.cumsum(flat, axis=1) - flat) * flat).sum(-1)
    return np.asarray(topi).reshape(B, S * topk), np.asarray(pos < C)


def test_moe_capacity_matches_reference_package():
    for S in (1, 7, 32, 1024):
        for E, k in ((4, 2), (8, 2), (16, 2), (128, 8)):
            for cf in (0.3, 1.0, 1.25, 8.0):
                assert tmoe.moe_capacity(S, E, k, cf) == jmoe.moe_capacity(S, E, k, cf)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.3])
@pytest.mark.parametrize("topk", [1, 2])
def test_moe_ffn_matches_reference_package(capacity_factor, dtype, topk):
    x, r, wg, wu, wd = _moe_inputs(int(capacity_factor * 10) + topk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    kw = dict(topk=topk, capacity_factor=capacity_factor)
    yj, aj = jmoe.moe_ffn(jx, *map(jnp.asarray, (r, wg, wu, wd)), **kw)
    yt, at = tmoe.moe_ffn(tx, *map(torch.from_numpy, (r, wg, wu, wd)), **kw)
    assert yt.dtype == tdt and yt.shape == x.shape and at.dtype == torch.float32
    eid, keep = _ref_keep(jx, jnp.asarray(r), **kw)
    route = tmoe.moe_route(tx, torch.from_numpy(r), **kw)
    np.testing.assert_array_equal(route.topi.reshape(eid.shape).numpy(), eid)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    if capacity_factor < 1:
        assert not keep.all()  # the case drops entries
    scale = max(float(np.abs(_np(yj)).max()), 1.0)
    tol = F32_TOL if dtype == "float32" else BF16_TOL * scale
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=0, atol=tol)
    assert abs(float(at) - float(aj)) <= 1e-6


@pytest.mark.parametrize("topk", [1, 2, 3])
def test_moe_ties_choose_the_lower_experts_as_reference_package(topk):
    """A zero router: every probability ties, the lower index wins."""
    x, _, wg, wu, wd = _moe_inputs(7, E=8)
    r = np.zeros((x.shape[-1], 8), np.float32)
    kw = dict(topk=topk, capacity_factor=1.25)
    eid, keep = _ref_keep(jnp.asarray(x), jnp.asarray(r), **kw)
    route = tmoe.moe_route(torch.from_numpy(x), torch.from_numpy(r), **kw)
    np.testing.assert_array_equal(eid.reshape(2, 32, topk),
                                  np.broadcast_to(np.arange(topk), (2, 32, topk)))
    np.testing.assert_array_equal(route.topi.numpy(), eid.reshape(2, 32, topk))
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    yj, aj = jmoe.moe_ffn(*map(jnp.asarray, (x, r, wg, wu, wd)), **kw)
    yt, at = tmoe.moe_ffn(*map(torch.from_numpy, (x, r, wg, wu, wd)), **kw)
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=0, atol=F32_TOL)
    assert abs(float(at) - float(aj)) <= 1e-6


def test_moe_capacity_drops_tokens():
    """With tiny capacity, the output differs from the no-drop case (the JAX
    package's test_moe_capacity_drops_tokens)."""
    x, r, wg, wu, wd = map(torch.from_numpy, _moe_inputs(1, B=1, d=8, f=16))
    y_nodrop, _ = tmoe.moe_ffn(x, r, wg, wu, wd, topk=2, capacity_factor=16.0)
    y_drop, _ = tmoe.moe_ffn(x, r, wg, wu, wd, topk=2, capacity_factor=0.3)
    assert float((y_nodrop - y_drop).abs().max()) > 1e-4


def test_moe_ffn_without_aux_gives_the_same_output():
    """``with_aux=False`` (the decode path) returns the same output bits
    and no aux."""
    x, r, wg, wu, wd = map(torch.from_numpy, _moe_inputs(2, B=1, d=8, f=16))
    kw = dict(topk=2, capacity_factor=1.25)
    y, aux = tmoe.moe_ffn(x, r, wg, wu, wd, **kw)
    y0, aux0 = tmoe.moe_ffn(x, r, wg, wu, wd, with_aux=False, **kw)
    assert aux0 is None and float(aux) > 0 and torch.equal(y0, y)


def test_moe_combine_weights_normalized():
    """Top-k gate weights renormalize to 1: with a uniform router, top-1 and
    top-2 give the same output (the JAX package's
    test_moe_combine_weights_normalized)."""
    B, S, d, E, f = 1, 8, 4, 8, 8
    x = torch.ones((B, S, d))
    r = torch.zeros((d, E))
    wg = torch.ones((E, d, f)) * 0.1
    wu = torch.ones((E, d, f)) * 0.1
    wd = torch.ones((E, f, d)) * 0.1
    y1, _ = tmoe.moe_ffn(x, r, wg, wu, wd, topk=1, capacity_factor=8.0)
    y2, _ = tmoe.moe_ffn(x, r, wg, wu, wd, topk=2, capacity_factor=8.0)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5)


@pytest.mark.parametrize("D", [16, 128])
def test_mrope_matches_reference_package(D):
    assert tcommon.mrope_sections(D) == jcommon.mrope_sections(D)
    rng = np.random.default_rng(D)
    B, S, H = 2, 24, 3
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    t = np.arange(S)
    # three different streams: a section mix-up changes the result
    pos = np.stack([np.broadcast_to(t, (B, S)), np.broadcast_to(t // 4, (B, S)) + 3,
                    np.broadcast_to(t % 5, (B, S)) * 7]).astype(np.int32)
    assert len({tuple(p.ravel()) for p in pos}) == 3
    ref = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos).long(), 1_000_000.0)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=F32_TOL)
    # equal streams give plain RoPE, in both
    eq = np.broadcast_to(t, (3, B, S)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(eq.copy()).long(), 1e6)),
        _np(tcommon.apply_rope(torch.from_numpy(x), torch.arange(S), 1e6)), atol=F32_TOL)


@pytest.mark.parametrize("seq,d_model", [(32, 64), (1024, 1024)])
def test_sinusoid_positions_match_reference_package(seq, d_model):
    ref = jcommon.sinusoid_positions(seq, d_model)
    got = tcommon.sinusoid_positions(seq, d_model)
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, d_model)
    # angles reach seq radians: a float32 ulp of the frequency moves them by
    # up to seq * 2^-24 (6e-5 at seq 1024)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=F32_TOL * max(1, seq / 128))
    pos = np.array([0, 5, seq - 1], np.int32)
    np.testing.assert_allclose(
        _np(tcommon.sinusoid_rows(torch.from_numpy(pos), d_model)),
        _np(jt._sinusoid_row(jnp.asarray(pos), d_model)), rtol=0,
        atol=F32_TOL * max(1, seq / 128))
