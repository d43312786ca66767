"""The port's MoE, hybrid, encoder-decoder and VLM models against the JAX
package's, on the CPU.

On ``cfg.reduced()`` of the five configurations these families add
(mixtral-8x7b, qwen3-moe-235b-a22b, jamba-v0.1-52b at capacity factor
8.0, as ``tests/test_models.py:_reduced`` runs them; mixtral once more at
its own 1.25; whisper-medium; qwen2-vl-2b), with the JAX package's
initialised parameters carried across by ``convert.lm_params_from_numpy``
and the same numpy inputs (frames and vision embeddings N(0, 0.02^2) in
bf16; three different mrope position streams):

* every sublayer of a forward pass (embedding, encoder layers, self- and
  cross-attention with their k / v, Mamba with its conv and ssm states,
  MLP, MoE, logits), each fed the reference's own input, within
  ``SUBLAYER_TOL`` of the reference output's largest magnitude: both round
  the sublayer's result to bf16, and the two frameworks round some float32
  ops (rsqrt, exp, silu) an ulp apart, so an entry may land a bf16 ulp or
  two (2^-8 .. 2^-7 of its scale) away.  This is what holds every slot of
  a prefill cache to the reference's numbers;
* forward logits and aux, prefill logits and cache (``xk`` / ``xv``
  included), ``pad_cache``, and ``decode_step`` logits and cache (both fed
  the reference's prefill cache) within ``LOGIT_TOL`` = 0.1, caches within
  0.1 of their largest magnitude, as ``tests/test_torch_lm.py`` holds the
  dense and Mamba-2 models.  jamba is the exception for whole sequences:
  one bf16 ulp anywhere grows over its sixteen layers into tenths of a
  logit.  The reference itself, with its embedding one bf16 ulp away, lies
  0.95 from its own forward logits at these inputs; the port lies 0.465
  (forward) and 0.299 (prefill, either impl).  So jamba's whole-sequence
  logits are held within ``JAMBA_LOGIT_TOL`` = 0.5, set from those
  readings, and its whole prefill cache only to the reference's keys,
  shapes and dtypes; its numbers are held slot by slot above, and their
  placement by the float32 test below;
* the prefill == forward and decode-after-prefill == forward properties of
  ``tests/test_models.py`` on the port itself, with that test's own
  parameters, inputs and tolerances (1e-3; 0.15), jamba's second within
  ``JAMBA_DECODE_TOL`` = 0.25: there the port reads 0.19 and the reference
  0.07 at key 0, and over keys 0-5 the reference reads up to 0.43 (key 3,
  where a router entry with a margin of 8e-5 flips between its two paths)
  and the port up to 0.66 (key 2, flips in four MoE layers).  With float32
  activations the port's gap is 4e-6 .. 1.8e-5 at all six keys, keys 2
  and 3 included, so the bf16 gap is rounding carried through the layers, not a
  wrong path; the float32 run is held within ``F32_TOL`` = 1e-4 for every
  model;
* the sliding-window ring at window 8 (reduced mixtral) against the
  reference, a burst through reduced mixtral in the port's ``Engine``
  against the reference ``Engine`` (greedy-token margin rule of
  ``tests/test_torch_lm.py``), ``launch.serve --reduced`` for the three
  models ``Engine`` serves, its refusal of whisper and qwen2-vl,
  ``build_params`` = ``compute_params(init())`` bit for bit, and a cache
  whose cross-KV is longer than its self-KV through
  ``convert.lm_cache_from_numpy``.

Routers.  A MoE router turns a bf16 ulp in its input into another expert
when two of a token's probabilities nearly tie, and another expert is an
O(1) change, so the whole-model comparisons (forward, prefill, decode,
the ring, the burst) zero every router: all probabilities then tie and the
tie order (lower index first, ``tests/test_torch_moe.py``) fixes each
token's experts in both packages; at capacity 1.25 the queues of experts
0..k-1 overflow, so drops are compared too.  The sublayer test keeps the
reference's random routers (identical inputs), and
``tests/test_torch_moe.py`` compares random routing's kept sets exactly.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec
from repro.configs.base import get_config as jget
from repro.launch import cells as jcells
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs.base import ModelConfig, ShapeSpec as TShape, get_config as tget
from repro_torch.launch import cells as tcells
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.serve.engine import Engine as TEngine
from test_torch_lm import LOGIT_TOL, _burst_matches_reference_package, _close_tree, _np

FAMILIES = [("mixtral-8x7b", 8.0), ("mixtral-8x7b", 1.25), ("qwen3-moe-235b-a22b", 8.0),
            ("jamba-v0.1-52b", 8.0), ("whisper-medium", None), ("qwen2-vl-2b", None)]
SUBLAYER_TOL = 2.0 ** -6
JAMBA_LOGIT_TOL = 0.5
JAMBA_DECODE_TOL = 0.25
F32_TOL = 1e-4
B, S = 2, 16


def _cfgs(name, cf, **kw):
    jc, tc = jget(name).reduced(**kw), tget(name).reduced(**kw)
    if cf is not None:
        jc, tc = (dataclasses.replace(c, capacity_factor=cf) for c in (jc, tc))
    return jc, tc


def _zero_routers(params):
    blocks = [dict(s, ffn=dict(s["ffn"], router=jnp.zeros_like(s["ffn"]["router"])))
              if "router" in s.get("ffn", {}) else s for s in params["blocks"]]
    return dict(params, blocks=blocks)


def _inputs(cfg, seed, seq=S, equal_streams=False):
    """numpy inputs for a prefill of ``seq`` tokens (plus the token after)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, seq + 1)).astype(np.int32)}
    if cfg.is_encdec:
        out["frames"] = (rng.standard_normal((B, seq, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.vision_tokens:
        out["vision_embeds"] = (rng.standard_normal((B, cfg.vision_tokens, cfg.d_model))
                                * 0.02).astype(np.float32)
        t = np.broadcast_to(np.arange(seq), (B, seq))
        streams = (t, t, t) if equal_streams else (t, t // 3 + 2, (t % 5) * 3)
        out["mrope_pos"] = np.stack(streams).astype(np.int32)
    return out


def _jkw(inp):
    kw = {}
    for k in ("frames", "vision_embeds"):
        if k in inp:
            kw[k] = jnp.asarray(inp[k]).astype(jnp.bfloat16)
    if "mrope_pos" in inp:
        kw["mrope_pos"] = jnp.asarray(inp["mrope_pos"])
    return kw


def _tkw(inp):
    kw = {}
    for k in ("frames", "vision_embeds"):
        if k in inp:
            kw[k] = torch.from_numpy(inp[k]).bfloat16()
    if "mrope_pos" in inp:
        kw["mrope_pos"] = torch.from_numpy(inp["mrope_pos"]).long()
    return kw


@pytest.fixture(scope="module", params=FAMILIES, ids=lambda p: f"{p[0]}-cf{p[1]}")
def family(request):
    """(jcfg, tcfg, reference params, port params) with zeroed routers,
    and the reference's forward / prefill / decode outputs."""
    name, cf = request.param
    jcfg, tcfg = _cfgs(name, cf)
    params = _zero_routers(jt.init(jcfg, jax.random.PRNGKey(0)))
    tparams = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    inp = _inputs(jcfg, 1)
    toks = inp["tokens"][:, :S]
    ref = {"forward": jt.forward(jcfg, params, jnp.asarray(toks), **_jkw(inp)),
           "prefill": jt.prefill(jcfg, params, jnp.asarray(toks), **_jkw(inp))}
    return jcfg, tcfg, params, tparams, inp, ref


def test_config_fields_match_reference_package():
    for name, _ in FAMILIES:
        for jc, tc in ((jget(name), tget(name)), _cfgs(name, None)):
            for f in ModelConfig.__dataclass_fields__:
                assert getattr(tc, f) == getattr(jc, f), (name, f)
            assert tc.layer_plan() == jc.layer_plan() and tc.n_blocks == jc.n_blocks
            assert tc.param_count() == jc.param_count()


def test_params_carried_across(family):
    jcfg, tcfg, params, tparams, _, _ = family
    assert len(jax.tree.leaves(params)) == len(jax.tree.leaves(tparams))
    if jcfg.is_encdec:
        np.testing.assert_array_equal(_np(tparams["encoder"]["frames_proj"]),
                                      np.asarray(params["encoder"]["frames_proj"]))


def test_sublayers_match_reference_package(family):
    """Each sublayer fed the reference's input (the reference's random
    routers restored)."""
    jcfg, tcfg, _, _, inp, _ = family
    params = jt.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    toks = inp["tokens"][:, :S]
    jkw, tkw = _jkw(inp), _tkw(inp)
    checked = []

    def same(name, j, t):
        scale = max(float(np.abs(_np(j)).max()), 1.0)
        np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=SUBLAYER_TOL * scale,
                                   err_msg=name)
        checked.append(name)
        return torch.from_numpy(np.asarray(j, np.float32)).to(t.dtype)  # the reference's

    x_j = jt._embed(jcfg, params, jnp.asarray(toks), jkw.get("vision_embeds"))
    x_t = same("embed", x_j, tt._embed(tcfg, tparams, torch.from_numpy(toks).long(),
                                       tkw.get("vision_embeds")))
    enc_j = enc_t = None
    if jcfg.is_encdec:
        enc_j = jt.encode(jcfg, params, jkw["frames"])
        enc_t = same("encode", enc_j, tt.encode(tcfg, tparams, tkw["frames"]))
        e = params["encoder"]
        h_j = jkw["frames"] @ e["frames_proj"].astype(jnp.bfloat16)
        h_j = h_j + jt.sinusoid_positions(S, jcfg.d_model).astype(h_j.dtype)
        h_t = tkw["frames"] @ tparams["encoder"]["frames_proj"].to(torch.bfloat16)
        h_t = h_t + tt.sinusoid_positions(S, tcfg.d_model).to(h_t.dtype)
        h_t = same("frames_proj", h_j, h_t)
        for i in range(jcfg.encoder_layers):
            sj = jax.tree.map(lambda a: a[i], e["blocks"][0])
            st = tt.layer(tparams["encoder"]["blocks"][0], i)
            h_j, _ = jt.attn_full(jcfg, sj["mixer"], h_j, positions=jnp.arange(S), causal=False)
            h_t, _ = tt.attn_full(tcfg, st["mixer"], h_t, positions=torch.arange(S), causal=False)
            h_t = same(f"encoder {i} attn", h_j, h_t)
            h_j = jt.mlp_sublayer(jcfg, sj["ffn"], h_j)
            h_t = same(f"encoder {i} mlp", h_j, tt.mlp_sublayer(tcfg, st["ffn"], h_t))
    for blk in range(jcfg.n_blocks):
        for i, (mixer, ffn) in enumerate(jcfg.layer_plan()):
            sj = jax.tree.map(lambda a: a[blk], params["blocks"][i])
            st = tt.layer(tparams["blocks"][i], blk)
            if mixer == "attn":
                x_j, kv_j = jt.attn_full(jcfg, sj["mixer"], x_j, positions=jnp.arange(S),
                                         mrope_pos=jkw.get("mrope_pos"))
                x_t, kv_t = tt.attn_full(tcfg, st["mixer"], x_t, positions=torch.arange(S),
                                         mrope_pos=tkw.get("mrope_pos"))
                x_t = same(f"{blk}.{i} attn", x_j, x_t)
                same(f"{blk}.{i} k", kv_j[0], kv_t[0])
                same(f"{blk}.{i} v", kv_j[1], kv_t[1])
                if jcfg.is_encdec:
                    xkv_j = jt._build_xkv(jcfg, sj["xattn"], enc_j)
                    xkv_t = tt._build_xkv(tcfg, st["xattn"], enc_t)
                    same(f"{blk}.{i} xk", xkv_j[0], xkv_t[0])
                    x_j = jt.xattn_full(jcfg, sj["xattn"], x_j, xkv_j)
                    x_t = same(f"{blk}.{i} xattn", x_j, tt.xattn_full(
                        tcfg, st["xattn"], x_t, tuple(
                            torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                            for a in xkv_j)))
            else:
                x_j, mc_j = jt.mamba_full(jcfg, sj["mixer"], x_j, return_cache=True)
                x_t, mc_t = tt.mamba_full(tcfg, st["mixer"], x_t, return_cache=True)
                x_t = same(f"{blk}.{i} mamba", x_j, x_t)
                same(f"{blk}.{i} conv", mc_j.conv, mc_t.conv)
                same(f"{blk}.{i} ssm", mc_j.ssm, mc_t.ssm)
            if ffn == "mlp":
                x_j = jt.mlp_sublayer(jcfg, sj["ffn"], x_j)
                x_t = same(f"{blk}.{i} mlp", x_j, tt.mlp_sublayer(tcfg, st["ffn"], x_t))
            elif ffn == "moe":
                x_j, a_j = jt.moe_sublayer(jcfg, sj["ffn"], x_j)
                y_t, a_t = tt.moe_sublayer(tcfg, st["ffn"], x_t)
                assert abs(float(a_t) - float(a_j)) <= 1e-6
                x_t = same(f"{blk}.{i} moe", x_j, y_t)
    lj = jt._logits(jcfg, params, x_j)
    np.testing.assert_allclose(_np(tt._logits(tcfg, tparams, x_t)), _np(lj), rtol=0,
                               atol=LOGIT_TOL)
    assert len(checked) >= jcfg.n_layers * 2


def _seq_tol(cfg):
    return JAMBA_LOGIT_TOL if cfg.family == "hybrid" else LOGIT_TOL


def test_forward_matches_reference_package(family):
    jcfg, tcfg, params, tparams, inp, ref = family
    lj, aj = ref["forward"]
    lt, at = tt.forward(tcfg, tparams, torch.from_numpy(inp["tokens"][:, :S]).long(),
                        **_tkw(inp))
    assert lt.shape == lj.shape and lt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=_seq_tol(jcfg))
    assert at.dtype == torch.float32 and abs(float(at) - float(aj)) <= 1e-6
    if jcfg.n_experts:
        assert float(aj) > 0


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_prefill_matches_reference_package(family, impl):
    jcfg, tcfg, params, tparams, inp, ref = family
    lj, cj = ref["prefill"]
    lt, ct = tt.prefill(tcfg, tparams, torch.from_numpy(inp["tokens"][:, :S]).long(),
                        impl=impl, **_tkw(inp))
    assert lt.shape == lj.shape
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=_seq_tol(jcfg))
    if jcfg.family == "hybrid":  # held slot by slot and through float32 decode instead
        for a, b in zip(ct, cj):
            assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in a.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in b.items()}
    else:
        _close_tree(ct, cj, 0.1)
    if jcfg.is_encdec:
        assert ct[0]["xk"].shape == cj[0]["xk"].shape


def test_decode_step_and_pad_cache_match_reference_package(family):
    jcfg, tcfg, params, tparams, inp, ref = family
    _, cj = ref["prefill"]
    cap = S + 8
    # the same cache on both sides, so decode is compared alone
    ct = convert.lm_cache_from_numpy(tcfg, jax.tree.map(np.asarray, cj), "cpu")
    cj, ct = jt.pad_cache(jcfg, cj, cap), tt.pad_cache(tcfg, ct, cap)
    _close_tree(ct, cj, 0.0)
    tok = inp["tokens"][:, S:]
    pos = np.array([S, S - 3], np.int32)  # per-slot positions
    lj, cj2 = jt.decode_step(jcfg, params, cj, jnp.asarray(tok), jnp.asarray(pos))
    lt, ct2 = tt.decode_step(tcfg, tparams, ct, torch.from_numpy(tok).long(),
                             torch.from_numpy(pos))
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=LOGIT_TOL)
    _close_tree(ct2, cj2, 0.1)


@pytest.mark.parametrize("name,cf", [f for f in FAMILIES if f[1] != 1.25])
def test_prefill_and_decode_match_forward(name, cf):
    """prefill == forward at the last position; prefill(S-1) + decode ==
    forward(S), on the port: ``tests/test_models.py``'s two tests with
    their own parameters, inputs (``make_inputs`` of the JAX package at
    its SMOKE shape, key 0) and tolerances (jamba: see the docstring)."""
    jcfg, tcfg = _cfgs(name, cf)
    key = jax.random.PRNGKey(0)
    params = jt.init(jcfg, key)
    tparams = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    jb = jcells.make_inputs(jcfg, ShapeSpec("smoke", 32, 2, "train"), key)
    n = 32
    toks = torch.from_numpy(np.array(jb["inputs"])).long()
    batch = {k: convert.tensor_from_numpy(jb[k], "cpu")
             for k in ("vision_embeds", "mrope_pos", "frames") if k in jb}
    if "mrope_pos" in batch:
        batch["mrope_pos"] = batch["mrope_pos"].long()
    full, _ = tt.forward(tcfg, tparams, toks, **batch)
    pre, _ = tt.prefill(tcfg, tparams, toks, **batch)
    np.testing.assert_allclose(_np(full[:, -1]), _np(pre[:, 0]), atol=1e-3)
    short = {k: (v[:, :, :n - 1] if k == "mrope_pos" else v[:, :n - 1] if k == "frames" else v)
             for k, v in batch.items()}
    _, cache = tt.prefill(tcfg, tparams, toks[:, :n - 1], cache_dtype=torch.float32, **short)
    cache = tt.pad_cache(tcfg, cache, n)
    ld, _ = tt.decode_step(tcfg, tparams, cache, toks[:, n - 1:], torch.full((B,), n - 1))
    gap = float((full[:, -1].float() - ld[:, 0].float()).abs().max())
    assert gap < (JAMBA_DECODE_TOL if jcfg.family == "hybrid" else 0.15), gap


@pytest.mark.parametrize("name,cf", [f for f in FAMILIES if f[1] != 1.25])
def test_decode_after_prefill_equals_forward_in_float32(name, cf, monkeypatch):
    """The port with float32 activations (the random routers of
    ``tests/test_models.py``'s key 0 kept): prefill(S-1) + decode ==
    forward(S) within F32_TOL, and prefill == forward.  A bf16 ulp grows
    to tenths of a logit over jamba's layers, so in bf16 this holds only
    loosely; in float32 a wrong or misplaced cache entry (a zeroed or
    swapped Mamba state, a conv window off by one) still shows.  whisper's
    encoder sees all S frames in both runs."""
    monkeypatch.setattr(tt, "ACT_DTYPE", torch.float32)
    jcfg, tcfg = _cfgs(name, cf)
    key = jax.random.PRNGKey(0)
    tparams = convert.lm_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jt.init(jcfg, key)), "cpu")
    jb = jcells.make_inputs(jcfg, ShapeSpec("smoke", 32, 2, "train"), key)
    n = 32
    toks = torch.from_numpy(np.array(jb["inputs"])).long()
    batch = {k: convert.tensor_from_numpy(jb[k], "cpu").float()
             for k in ("vision_embeds", "frames") if k in jb}
    if "mrope_pos" in jb:
        batch["mrope_pos"] = torch.from_numpy(np.array(jb["mrope_pos"])).long()
    full, _ = tt.forward(tcfg, tparams, toks, **batch)
    pre, _ = tt.prefill(tcfg, tparams, toks, **batch)
    assert full.dtype == torch.float32
    np.testing.assert_allclose(_np(pre[:, 0]), _np(full[:, -1]), rtol=0, atol=F32_TOL)
    if "mrope_pos" in batch:
        batch["mrope_pos"] = batch["mrope_pos"][:, :, :n - 1]
    _, cache = tt.prefill(tcfg, tparams, toks[:, :n - 1], cache_dtype=torch.float32, **batch)
    cache = tt.pad_cache(tcfg, cache, n)
    ld, _ = tt.decode_step(tcfg, tparams, cache, toks[:, n - 1:], torch.full((B,), n - 1))
    np.testing.assert_allclose(_np(ld[:, 0]), _np(full[:, -1]), rtol=0, atol=F32_TOL)


def test_make_inputs_match_reference_specs():
    for name, _ in FAMILIES:
        jc, tc = _cfgs(name, None)
        for kind in ("train", "prefill", "decode"):
            js = jcells.input_specs(jc, ShapeSpec("t", 24, 2, kind))
            ts = tcells.input_specs(tc, TShape("t", 24, 2, kind))
            assert list(ts) == list(js), (name, kind)
            for k, (shape, _) in ts.items():
                assert shape == tuple(js[k].shape), (name, kind, k)
            got = tcells.make_inputs(tc, TShape("t", 24, 2, kind),
                                     torch.Generator().manual_seed(0))
            for k, (shape, dtype) in ts.items():
                assert tuple(got[k].shape) == shape and got[k].dtype == dtype
    with pytest.raises(ValueError, match="kind"):
        tcells.input_specs(tc, TShape("s", 8, 1, "score"))


def test_sliding_window_ring_matches_reference_package():
    """reduced mixtral at window 8, prompt 24: the ring cache, its padding
    (none at full window) and a decode step (tests/test_models.py's
    test_sliding_window_ring_evicts, against the reference)."""
    jcfg, tcfg = _cfgs("mixtral-8x7b", 8.0, sliding_window=8)
    params = _zero_routers(jt.init(jcfg, jax.random.PRNGKey(1)))
    tparams = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    n = 24
    toks = _inputs(jcfg, 4, seq=n)["tokens"]
    lj, cj = jt.prefill(jcfg, params, jnp.asarray(toks[:, :n]), cache_dtype=jnp.float32)
    lt, ct = tt.prefill(tcfg, tparams, torch.from_numpy(toks[:, :n]).long(),
                        cache_dtype=torch.float32)
    np.testing.assert_allclose(_np(lt), _np(lj), atol=LOGIT_TOL)
    assert ct[0]["k"].shape[2] == 8
    _close_tree(ct, cj, 0.1)
    cj, ct = jt.pad_cache(jcfg, cj, n + 1), tt.pad_cache(tcfg, ct, n + 1)
    assert ct[0]["k"].shape[2] == 8  # a full ring is not padded
    pos = np.full((B,), n, np.int32)
    lj, _ = jt.decode_step(jcfg, params, cj, jnp.asarray(toks[:, n:]), jnp.asarray(pos))
    lt, _ = tt.decode_step(tcfg, tparams, ct, torch.from_numpy(toks[:, n:]).long(),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=LOGIT_TOL)


def test_engine_burst_matches_reference_package():
    """Reduced mixtral (capacity 1.25, zero routers) through both engines:
    greedy tokens equal up to the first position where the reference's
    top-2 logit margin is below MARGIN, every compared logit within
    LOGIT_TOL (tests/test_torch_lm.py's rule)."""
    jcfg, tcfg = _cfgs("mixtral-8x7b", 1.25)
    params = _zero_routers(jt.init(jcfg, jax.random.PRNGKey(0)))
    tparams = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    _burst_matches_reference_package(jcfg, tcfg, params, tparams)


@pytest.mark.parametrize("config", ["mixtral-8x7b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b"])
def test_serve_cli_runs_on_cpu(config, capsys):
    assert config in tserve.served_configs()
    assert tserve.main(["--device", "cpu", "--reduced", "--config", config,
                        "--requests", "2", "--slots", "2", "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests" in out and "on cpu" in out


@pytest.mark.parametrize("config", ["whisper-medium", "qwen2-vl-2b"])
def test_engine_refuses_frames_and_vision_families(config):
    cfg = tget(config).reduced()
    assert config not in tserve.served_configs()
    with pytest.raises(ValueError, match="serve.steps"):
        TEngine(cfg, {"embed": torch.zeros(1)}, slots=1, max_len=8)


def test_build_params_equal_compute_params_of_init():
    cfg = tget("jamba-v0.1-52b").reduced()
    got = tserve.build_params(cfg, 3, "cpu")
    want = tt.compute_params(tt.init(cfg, torch.Generator().manual_seed(3)))
    flat_g, flat_w = [], []
    jax.tree.map(lambda a: flat_g.append(a), got)  # sorted leaf order, as jax
    jax.tree.map(lambda a: flat_w.append(a), want)
    assert len(flat_g) == len(flat_w) > 0
    for a, b in zip(flat_g, flat_w):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["blocks"][1]["ffn"]["router"].dtype == torch.float32
    assert got["blocks"][1]["ffn"]["w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_whisper_prefill_over_a_ragged_frame_count(impl):
    """136 frames, no multiple of the kernel's 128-row KV block: the port's
    non-causal encoder and cross-attention take it through the kernel
    wrapper (``ragged_kv=True``), as the reference's jnp path takes any
    count up to 1024; logits and cross-KV as the reference's."""
    jcfg, tcfg = _cfgs("whisper-medium", None)
    params = jt.init(jcfg, jax.random.PRNGKey(3))
    tparams = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab_size, (B, 8)).astype(np.int32)
    frames = (rng.standard_normal((B, 136, jcfg.d_model)) * 0.02).astype(np.float32)
    lj, cj = jt.prefill(jcfg, params, jnp.asarray(toks),
                        frames=jnp.asarray(frames).astype(jnp.bfloat16))
    lt, ct = tt.prefill(tcfg, tparams, torch.from_numpy(toks).long(), impl=impl,
                        frames=torch.from_numpy(frames).bfloat16())
    assert ct[0]["xk"].shape[2] == 136
    np.testing.assert_allclose(_np(lt), _np(lj), rtol=0, atol=LOGIT_TOL)
    _close_tree(ct, cj, 0.1)


def test_cache_with_longer_cross_kv_carried_across():
    """whisper: 8 prompt tokens against 24 encoder frames; the converted
    cache keeps both lengths and decodes as the reference's does."""
    jcfg, tcfg = _cfgs("whisper-medium", None)
    params = jt.init(jcfg, jax.random.PRNGKey(2))
    tparams = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab_size, (B, 9)).astype(np.int32)
    frames = (rng.standard_normal((B, 24, jcfg.d_model)) * 0.02).astype(np.float32)
    _, cj = jt.prefill(jcfg, params, jnp.asarray(toks[:, :8]),
                       frames=jnp.asarray(frames).astype(jnp.bfloat16))
    ct = convert.lm_cache_from_numpy(tcfg, jax.tree.map(np.asarray, cj), "cpu")
    assert ct[0]["k"].shape[2] == 8 and ct[0]["xk"].shape[2] == 24
    _close_tree(ct, cj, 0.0)
    cj, ct = jt.pad_cache(jcfg, cj, 12), tt.pad_cache(tcfg, ct, 12)
    assert ct[0]["k"].shape[2] == 12 and ct[0]["xk"].shape[2] == 24
    pos = np.full((B,), 8, np.int32)
    lj, _ = jt.decode_step(jcfg, params, cj, jnp.asarray(toks[:, 8:]), jnp.asarray(pos))
    lt, _ = tt.decode_step(tcfg, tparams, ct, torch.from_numpy(toks[:, 8:]).long(),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=LOGIT_TOL)
