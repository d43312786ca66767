"""The port's attention against the JAX package's, on the CPU.

Same inputs (numpy, seeded) through both packages:
* ``attention_reference`` and the chunked ``flash_attention`` against the
  JAX package's, and the kernel wrapper (its plain version on the CPU)
  against the JAX Pallas wrapper in interpret mode, on the sweep shapes of
  ``tests/test_kernels.py``.  Tolerance: 2e-5 in float32 (the JAX kernel
  tests' own), 3e-2 in bf16 (their bf16 tolerance: one bf16 rounding of
  outputs of magnitude ~1 is ~4e-3, the rest is the order of sums).
* ``decode_attention`` with per-sequence valid lengths and a window,
  caches in bf16, at 3e-2.
* The bf16 kernel's numerics, emulated (``_emulate_tensor_core_attention``),
  in each head-dim tier and at the models' GQA ratios, against the JAX
  package's reference and its Pallas wrapper in interpret mode at 3e-2;
  every config's head dim within the wrapper's ``MAX_HEAD_DIM``; and a
  reduced gemma-7b at its own head dim of 256, the port's kernel path (its
  plain version on the CPU) against the JAX package's Pallas path.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config as jget
from repro.kernels.flash_attention import ops as jfa
from repro.models import attention as jattn
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs.base import get_config as tget, list_configs
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as tt

SWEEP = [  # tests/test_kernels.py:11-17
    (2, 128, 128, 4, 2, 64, True, 0),
    (1, 256, 256, 8, 8, 64, True, 0),
    (2, 128, 128, 4, 1, 80, True, 0),
    (1, 256, 256, 4, 2, 64, True, 96),
    (2, 100, 128, 4, 2, 64, True, 0),
    (1, 64, 64, 2, 2, 128, True, 0),
]


def _qkv(seed, B, Sq, Skv, H, KV, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, D)).astype(np.float32))


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x).astype(dtype)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D,causal,window", SWEEP)
def test_attention_matches_reference_package(B, Sq, Skv, H, KV, D, causal, window):
    q, k, v = _qkv(Sq * 7 + D, B, Sq, Skv, H, KV, D)
    kw = dict(causal=causal, window=window)
    ref_j = jattn.attention_reference(_j(q), _j(k), _j(v), **kw)
    np.testing.assert_allclose(
        _np(tref.attention_reference(_t(q), _t(k), _t(v), **kw)), _np(ref_j), atol=2e-5)
    # the model's chunked path, in one chunk and in several
    for chunk in (1024, 64):
        np.testing.assert_allclose(
            _np(tattn.flash_attention(_t(q), _t(k), _t(v), chunk=chunk, **kw)),
            _np(jattn.flash_attention(_j(q), _j(k), _j(v), chunk=chunk, **kw)),
            atol=2e-5)
    # the kernel wrapper (plain version on the CPU) against the Pallas
    # kernel in interpret mode
    np.testing.assert_allclose(
        _np(tfa.flash_attention(_t(q), _t(k), _t(v), **kw)),
        _np(jfa.flash_attention(_j(q), _j(k), _j(v), **kw)), atol=2e-5)


@pytest.mark.parametrize("shape", [SWEEP[0], SWEEP[3]])
def test_attention_bf16_matches_reference_package(shape):
    B, Sq, Skv, H, KV, D, causal, window = shape
    q, k, v = _qkv(11, B, Sq, Skv, H, KV, D)
    kw = dict(causal=causal, window=window)
    bf = torch.bfloat16
    jq, jk, jv = (_j(x, jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (_t(x, bf) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, **kw)
    assert out.dtype == bf
    np.testing.assert_allclose(_np(out), _np(jfa.flash_attention(jq, jk, jv, **kw)),
                               atol=3e-2)
    np.testing.assert_allclose(
        _np(tattn.flash_attention(tq, tk, tv, **kw)),
        _np(jattn.flash_attention(jq, jk, jv, **kw)), atol=3e-2)


@pytest.mark.parametrize("q_offset,window", [(64, 0), (64, 48), (0, 32)])
def test_attention_q_offset_matches_reference_package(q_offset, window):
    q, k, v = _qkv(5, 1, 64, 128, 4, 2, 32)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    ref_j = jattn.attention_reference(_j(q), _j(k), _j(v), **kw)
    np.testing.assert_allclose(
        _np(tfa.flash_attention(_t(q), _t(k), _t(v), **kw)), _np(ref_j), atol=2e-5)
    np.testing.assert_allclose(
        _np(tattn.flash_attention(_t(q), _t(k), _t(v), chunk=32, **kw)),
        _np(jattn.flash_attention(_j(q), _j(k), _j(v), chunk=32, **kw)), atol=2e-5)


def test_non_causal_ragged_kv_is_refused_as_in_reference_package():
    q, k, v = _qkv(3, 1, 64, 200, 2, 2, 16)
    with pytest.raises(ValueError, match="non-causal"):
        jfa.flash_attention(_j(q), _j(k), _j(v), causal=False)
    with pytest.raises(ValueError, match="non-causal"):
        tfa.flash_attention(_t(q), _t(k), _t(v), causal=False)
    # a whole number of KV blocks is accepted by both
    q, k, v = _qkv(4, 1, 64, 256, 2, 2, 16)
    np.testing.assert_allclose(
        _np(tfa.flash_attention(_t(q), _t(k), _t(v), causal=False)),
        _np(jfa.flash_attention(_j(q), _j(k), _j(v), causal=False)), atol=2e-5)


@pytest.mark.parametrize("window", [0, 24])
def test_decode_attention_matches_reference_package(window):
    B, S, H, KV, D = 3, 64, 4, 2, 16
    rng = np.random.default_rng(9)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    vc = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    valid = np.array([64, 17, 1], np.int32)
    out_j = jattn.decode_attention(_j(q, jnp.bfloat16), _j(kc, jnp.bfloat16),
                                   _j(vc, jnp.bfloat16), window=window,
                                   valid_len=jnp.asarray(valid))
    out_t = tattn.decode_attention(_t(q, torch.bfloat16), _t(kc, torch.bfloat16),
                                   _t(vc, torch.bfloat16), window=window,
                                   valid_len=torch.from_numpy(valid))
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=3e-2)
    # float32 caches and a scalar valid length: 2e-5
    out_j = jattn.decode_attention(_j(q), _j(kc), _j(vc), window=window, valid_len=40)
    out_t = tattn.decode_attention(_t(q), _t(kc), _t(vc), window=window, valid_len=40)
    np.testing.assert_allclose(_np(out_t), _np(out_j), atol=2e-5)


# ---------------------------------------------------------------------------
# The bf16 kernel's numerics, emulated in plain torch before the card: the
# loop of csrc/flash_attention.cu (flash_attention_wgmma_kernel) over KV
# tiles of its head-dim tier's length (128 keys up to D=128, 80 at D=256).
# q * D**-0.5 rounded to bf16 (as the plain version computes it in q's
# dtype), bf16 q K^T summed in float32, the online softmax in float32 with
# the -1e30 sentinel, p rounded to bf16 per tile for P V while the running
# sum adds the unrounded p.  The kernel packs a KV head's g query heads as
# rows in (position, head) order; every row is its own softmax, so the
# packing reorders rows and changes no number, and the emulation keeps the
# (KV head, group) layout.
def _tile_keys(D):
    return 128 if D <= 128 else 80


def _emulate_tensor_core_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                                   tile=None):
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    tile = _tile_keys(D) if tile is None else tile
    G = H // KV
    qs = (q * D ** -0.5).float().reshape(B, Sq, KV, G, D)
    q_pos = q_offset + torch.arange(Sq)
    m = torch.full((B, KV, G, Sq), -1e30)
    l = torch.zeros((B, KV, G, Sq))
    acc = torch.zeros((B, KV, G, Sq, D))
    for t0 in range(0, Skv, tile):
        kt, vt = k[:, t0:t0 + tile].float(), v[:, t0:t0 + tile].float()
        s = torch.einsum("bqkgd,bckd->bkgqc", qs, kt)
        kv_pos = t0 + torch.arange(kt.shape[1])
        s = torch.where(tattn._mask(q_pos, kv_pos, causal, window), s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqc,bckd->bkgqd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(torch.bfloat16)


@pytest.mark.parametrize("D,window,q_offset", [(64, 0, 0), (80, 0, 0), (64, 96, 0),
                                               (64, 32, 400)])
def test_tensor_core_attention_numerics_match_reference_package(D, window, q_offset):
    """bf16 inputs, llama's GQA ratio (4 query heads per KV head), ragged
    tail (Skv=200): the emulated kernel against the JAX package's
    attention_reference at the card's bf16 tolerance (3e-2)."""
    B, Sq, Skv, H, KV = 1, 200, 200, 8, 2
    q, k, v = _qkv(31 + D, B, Sq, Skv, H, KV, D)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    ref = _np(jattn.attention_reference(*(_j(a, jnp.bfloat16) for a in (q, k, v)), **kw))
    out = _emulate_tensor_core_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)), **kw)
    assert np.abs(_np(out) - ref).max() <= 3e-2


# each head-dim tier (64, 128, 256: gemma) x the models' GQA ratios g = 1
# (whisper, gemma), 4 (llama, mixtral, jamba), 6 (qwen2-vl)
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 4, 6])
@pytest.mark.parametrize("window,q_offset", [(0, 0), (48, 64)])
def test_tensor_core_attention_tiers_match_reference_package(D, g, window, q_offset):
    """The emulated kernel at its tier's KV tile length, causal over a
    ragged Sq (136: neither tile length divides it) and a cached prefix of
    q_offset keys, against the JAX package's attention_reference and its
    Pallas wrapper in interpret mode (which pads D to a multiple of 128
    itself), at 3e-2."""
    B, Sq, KV = 1, 136, 2
    Skv, H = Sq + q_offset, g * KV
    q, k, v = _qkv(D + 7 * g + window, B, Sq, Skv, H, KV, D)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    jq, jk, jv = (_j(a, jnp.bfloat16) for a in (q, k, v))
    out = _np(_emulate_tensor_core_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                                             **kw))
    assert np.abs(out - _np(jattn.attention_reference(jq, jk, jv, **kw))).max() <= 3e-2
    assert np.abs(out - _np(jfa.flash_attention(jq, jk, jv, **kw))).max() <= 3e-2


@pytest.mark.parametrize("name", [n for n in list_configs() if tget(n).n_heads])
def test_config_head_dim_within_the_kernel(name):
    """Every config with attention runs it through the kernel wrapper on
    the card (whisper and qwen2-vl through serve.steps, the rest through
    Engine), so its head dim must be one the wrapper takes."""
    cfg = tget(name)
    assert 0 < cfg.head_dim_ <= tfa.MAX_HEAD_DIM, (name, cfg.head_dim_)


def test_gemma_prefill_at_its_head_dim_matches_reference_package():
    """gemma-7b reduced at its own head dim of 256 (the plain reduction sets
    16): the port's prefill with impl="kernel" (the wrapper's plain
    version on the CPU) against the JAX package's attn_impl="pallas" (the
    Pallas kernel in interpret mode), the JAX package's initialised
    parameters carried across.  Logits within 0.1 and caches within 0.1 of
    their largest magnitude, as tests/test_torch_lm.py holds prefill."""
    jcfg, tcfg = (get("gemma-7b").reduced(head_dim=256) for get in (jget, tget))
    assert tcfg.head_dim_ == 256 and tcfg.n_kv_heads == tcfg.n_heads
    params = jt.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    lj, cj = jt.prefill(jcfg, params, jnp.asarray(toks), attn_impl="pallas")
    lt, ct = tt.prefill(tcfg, tparams, torch.from_numpy(toks).long(), impl="kernel")
    assert lt.shape == lj.shape and lt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(lt), _np(lj), atol=0.1)
    for a, b in zip(ct, cj):
        assert set(a) == set(b)
        for key in a:
            pa, rb = _np(a[key]), _np(b[key])
            assert pa.shape == rb.shape, (key, pa.shape, rb.shape)
            np.testing.assert_allclose(pa, rb, rtol=0,
                                       atol=0.1 * max(np.abs(rb).max(), 1.0), err_msg=key)
