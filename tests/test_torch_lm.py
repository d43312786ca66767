"""The port's LM serving path against the JAX package's, on the CPU.

On ``cfg.reduced()`` of both served configurations (llama3.2-1b: dense
GQA attention + SwiGLU MLP; mamba2-780m: Mamba-2 SSD), with the JAX
package's initialised parameters carried across by
``convert.lm_params_from_numpy``:

* ``prefill`` logits and cache, ``pad_cache`` and ``decode_step``
  logits and cache against ``src/repro/models/transformer.py``;
* a 5-request burst through the port's ``Engine`` against the JAX
  package's ``Engine``: greedy tokens equal up to the first position where
  the reference's top-2 logit margin is below ``MARGIN``, and the logits of
  every position compared within ``LOGIT_TOL``;
* prefill == forward and decode-after-prefill == forward on the port
  itself, as ``tests/test_models.py`` holds the JAX model;
* ``launch/serve.py --device cpu --reduced`` runs and exits 0.

Tolerances: activations are bf16 in both packages, and the two frameworks
round some float32 ops (rsqrt, cos, exp) and bf16 ops (silu) differently
by an ulp, which bf16 roundings downstream turn into differences of a few
bf16 ulps: logits (|logit| <= ~2 here, bf16 ulp 2^-7..2^-6) agree within
``LOGIT_TOL`` = 0.1, caches within 0.1 of their largest magnitude.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import transformer as jt
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import Request as JRequest
from repro_torch import convert
from repro_torch.configs.base import ModelConfig, get_config as tget
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as tt
from repro_torch.serve.engine import Engine as TEngine
from repro_torch.serve.engine import Request as TRequest

CONFIGS = ["llama3.2-1b", "mamba2-780m"]
LOGIT_TOL = 0.1
MARGIN = 0.1


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    name = request.param
    jcfg, tcfg = jget(name).reduced(), tget(name).reduced()
    params = jt.init(jcfg, jax.random.PRNGKey(0))
    tparams = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    return jcfg, tcfg, params, tparams


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _close_tree(port, ref, rel):
    for a, b in zip(port, ref):
        assert set(a) == set(b)
        for k in a:
            pa, rb = _np(a[k]), _np(b[k])
            assert pa.shape == rb.shape, (k, pa.shape, rb.shape)
            np.testing.assert_allclose(pa, rb, rtol=0, atol=rel * max(np.abs(rb).max(), 1.0),
                                       err_msg=k)


def test_config_fields_match_reference_package():
    for name in CONFIGS:
        for jc, tc in ((jget(name), tget(name)), (jget(name).reduced(), tget(name).reduced())):
            for f in ModelConfig.__dataclass_fields__:
                assert getattr(tc, f) == getattr(jc, f), (name, f)
            assert tc.layer_plan() == jc.layer_plan() and tc.n_blocks == jc.n_blocks
            assert tc.param_count() == jc.param_count()


def test_params_carried_across(model):
    jcfg, tcfg, params, tparams = model
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree.leaves(tparams))  # same leaves, no extras
    np.testing.assert_array_equal(_np(tparams["embed"]), np.asarray(params["embed"]))
    with pytest.raises(ValueError, match="keys"):
        convert.lm_params_from_numpy(tcfg, {"embed": np.zeros((1, 1))}, "cpu")


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_prefill_matches_reference_package(model, impl):
    jcfg, tcfg, params, tparams = model
    toks = _tokens(jcfg, 2, 40 if jcfg.family == "dense" else 256)
    lj, cj = jt.prefill(jcfg, params, jnp.asarray(toks))
    lt, ct = tt.prefill(tcfg, tparams, torch.from_numpy(toks).long(), impl=impl)
    assert lt.shape == lj.shape and lt.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(lt), _np(lj), atol=LOGIT_TOL)
    _close_tree(ct, cj, 0.1)


def test_decode_step_and_pad_cache_match_reference_package(model):
    jcfg, tcfg, params, tparams = model
    S, cap = 24, 40
    toks = _tokens(jcfg, 2, S + 1, seed=1)
    _, cj = jt.prefill(jcfg, params, jnp.asarray(toks[:, :S]))
    # the same cache on both sides, so decode is compared alone
    ct = convert.lm_cache_from_numpy(tcfg, jax.tree.map(np.asarray, cj), "cpu")
    cj, ct = jt.pad_cache(jcfg, cj, cap), tt.pad_cache(tcfg, ct, cap)
    _close_tree(ct, cj, 0.0)
    pos = np.array([S, S - 3], np.int32)  # per-slot positions
    lj, cj2 = jt.decode_step(jcfg, params, cj, jnp.asarray(toks[:, S:]), jnp.asarray(pos))
    lt, ct2 = tt.decode_step(tcfg, tparams, ct, torch.from_numpy(toks[:, S:]).long(),
                             torch.from_numpy(pos))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=LOGIT_TOL)
    _close_tree(ct2, cj2, 0.1)


def test_sliding_window_ring_cache_matches_reference_package():
    """A windowed llama (prompt longer than the window): the prefill's ring
    cache, its padding (none at full window) and a decode step."""
    jcfg = jget("llama3.2-1b").reduced(sliding_window=16)
    tcfg = tget("llama3.2-1b").reduced(sliding_window=16)
    params = jt.init(jcfg, jax.random.PRNGKey(1))
    tparams = convert.lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params), "cpu")
    S = 40
    toks = _tokens(jcfg, 2, S + 1, seed=4)
    lj, cj = jt.prefill(jcfg, params, jnp.asarray(toks[:, :S]))
    lt, ct = tt.prefill(tcfg, tparams, torch.from_numpy(toks[:, :S]).long())
    np.testing.assert_allclose(_np(lt), _np(lj), atol=LOGIT_TOL)
    assert ct[0]["k"].shape[2] == 16
    _close_tree(ct, cj, 0.1)
    cj, ct = jt.pad_cache(jcfg, cj, 64), tt.pad_cache(tcfg, ct, 64)
    assert ct[0]["k"].shape[2] == 16  # a full ring is not padded
    pos = np.full((2,), S, np.int32)
    lj, _ = jt.decode_step(jcfg, params, cj, jnp.asarray(toks[:, S:]), jnp.asarray(pos))
    lt, _ = tt.decode_step(tcfg, tparams, ct, torch.from_numpy(toks[:, S:]).long(),
                           torch.from_numpy(pos))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=LOGIT_TOL)


def _recorded(eng, log, to_np):
    """Wrap an engine's prefill/decode steps to record, per call, the live
    slots' request ids and the last-position logits."""
    prefill, decode = eng.prefill, eng.decode

    def rec_prefill(params, batch):
        logits, cache = prefill(params, batch)
        log.append((None, to_np(logits[:, -1])))
        return logits, cache

    def rec_decode(params, cache, batch):
        rids = [r.rid if (r is not None and eng.live[i]) else None
                for i, r in enumerate(eng.req)]
        logits, cache = decode(params, cache, batch)
        log.append((rids, to_np(logits[:, -1])))
        return logits, cache

    eng.prefill, eng.decode = rec_prefill, rec_decode


def _per_request(log, order):
    """{rid: [logits of each generated token]} from a recorded run."""
    out = {rid: [] for rid in order}
    k = 0
    for rids, logits in log:
        if rids is None:  # the k-th prefill serves the k-th submitted request
            out[order[k]].append(logits[0])
            k += 1
        else:
            for slot, rid in enumerate(rids):
                if rid is not None:
                    out[rid].append(logits[slot])
    return out


def test_engine_burst_matches_reference_package(model):
    _burst_matches_reference_package(*model)


def _burst_matches_reference_package(jcfg, tcfg, params, tparams):
    """A 5-request burst through both engines (the rule in the module
    docstring)."""
    lengths, max_new = [8, 16, 8, 24, 16], [6, 9, 5, 7, 8]
    prompts = [_tokens(jcfg, 1, n, seed=10 + i)[0] for i, n in enumerate(lengths)]
    jeng = JEngine(jcfg, params, slots=2, max_len=48)
    teng = TEngine(tcfg, tparams, slots=2, max_len=48)
    jlog, tlog = [], []
    _recorded(jeng, jlog, lambda x: np.asarray(x, np.float32))
    _recorded(teng, tlog, lambda x: x.float().numpy())
    for i, (p, m) in enumerate(zip(prompts, max_new)):
        jeng.submit(JRequest(rid=i, prompt=p, max_new=m))
        teng.submit(TRequest(rid=i, prompt=p, max_new=m))
    jdone = {r.rid: r.out for r in jeng.run()}
    tdone = {r.rid: r.out for r in teng.run()}
    assert sorted(tdone) == sorted(jdone) == list(range(5))
    jl, tl = _per_request(jlog, list(range(5))), _per_request(tlog, list(range(5)))
    compared = total = 0
    for rid in range(5):
        assert len(tdone[rid]) == len(jdone[rid]) == max_new[rid]
        total += max_new[rid]
        for t, (a, b) in enumerate(zip(tdone[rid], jdone[rid])):
            np.testing.assert_allclose(tl[rid][t], jl[rid][t], atol=LOGIT_TOL,
                                       err_msg=f"request {rid}, token {t}")
            compared += 1
            if a != b:
                top2 = np.sort(jl[rid][t])[-2:]
                assert top2[1] - top2[0] < MARGIN, (rid, t, top2)
                break  # the sequences part: later tokens see other prefixes
    assert compared >= total // 2, (compared, total)


def test_prefill_and_decode_match_forward(model):
    """prefill == forward at the last position; prefill(S-1) + decode ==
    forward(S), on the port (tests/test_models.py's tolerances)."""
    jcfg, tcfg, params, tparams = model
    S = 32
    toks = torch.from_numpy(_tokens(tcfg, 2, S, seed=2)).long()
    full, _ = tt.forward(tcfg, tparams, toks)
    pre, _ = tt.prefill(tcfg, tparams, toks)
    np.testing.assert_allclose(_np(full[:, -1]), _np(pre[:, 0]), atol=1e-3)
    _, cache = tt.prefill(tcfg, tparams, toks[:, :S - 1], cache_dtype=torch.float32)
    cache = tt.pad_cache(tcfg, cache, S)
    ld, _ = tt.decode_step(tcfg, tparams, cache, toks[:, S - 1:], torch.full((2,), S - 1))
    assert float((full[:, -1].float() - ld[:, 0].float()).abs().max()) < 0.15


def test_compute_params_give_the_same_numbers(model):
    jcfg, tcfg, params, tparams = model
    toks = torch.from_numpy(_tokens(tcfg, 1, 16, seed=3)).long()
    a, _ = tt.prefill(tcfg, tparams, toks)
    b, _ = tt.prefill(tcfg, tt.compute_params(tparams), toks)
    assert torch.equal(a, b)


@pytest.mark.parametrize("config", CONFIGS)
def test_serve_cli_runs_on_cpu(config, capsys):
    assert tserve.main(["--device", "cpu", "--reduced", "--config", config,
                        "--requests", "3", "--slots", "2", "--seed", "1"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "on cpu" in out and "TTFT" in out
