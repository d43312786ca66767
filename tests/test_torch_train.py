"""The port's training path against the JAX package's, on the CPU.

Inputs are made from numpy seeds and carried across (``convert``): the
JAX package's parameters by ``lm_params_from_numpy``, its ``AdamWState`` by
``adamw_state_from_numpy``.

Tolerances:

* Float32 arithmetic alone (``cosine_schedule`` at steps 0-100,
  ``global_norm``, ``clip_by_global_norm``, ``adamw_update`` on identical
  float32 trees): rtol ``OPT_RTOL`` = 1e-6, a few float32 ulps (the two
  frameworks' ``pow``, ``cos`` and ``sqrt`` may differ by one).
* ``chunked_softmax_xent`` on the same bf16 hidden states: rtol 2e-4, as
  ``tests/test_train.py`` holds the JAX package's chunked loss against its
  naive one (float32 logits against bf16 ones).
* Gradients of ``loss_fn`` (reduced llama3.2-1b, mamba2-780m, mixtral-8x7b
  with zeroed routers, whose ties fix the experts on both sides): a
  per-leaf relative L2 of ``GRAD_REL_L2`` = 0.1.  Activations are bf16 in
  both packages and the frameworks round rsqrt, exp, silu by an ulp
  differently, which flips bf16 roundings: the JAX package itself moves
  1.6-4% in this norm when its parameters move by 2^-12 of themselves (a
  sixteenth of a bf16 ulp); the port lies 0.7-6% from it.  The losses
  agree within ``LOSS_RTOL`` = 1e-3 (readings 3e-5 to 1.2e-4).
* A whole step from the same state (its moments filled by a step at
  learning rate 0): loss as above, grad norm within rtol 1e-2 (readings
  up to 2.6e-3), and each leaf's update within a relative L2 of
  ``UPDATE_REL_L2`` = 0.3: Adam divides by each element's own gradient
  scale, so an element whose gradient is as small as that bf16 noise can
  take an update of the other sign (readings 0.08-0.14).
* ``remat=True`` against ``remat=False``: bitwise (the same operations
  recomputed on the CPU); ``accum=2`` against ``accum=1``: every parameter
  within 5e-4 (``test_accumulation_equivalence`` of the JAX package).
* A resumed launcher run against an uninterrupted one: bitwise.
"""
from __future__ import annotations

import collections
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import optim as jopt
from repro.configs.base import ShapeSpec
from repro.configs.base import get_config as jget
from repro.launch import cells as jcells
from repro.models import transformer as jt
from repro.train import step as jstep
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.checkpoint import store
from repro_torch.configs.base import get_config as tget
from repro_torch.configs.base import ShapeSpec as TShape
from repro_torch.configs.base import list_configs
from repro_torch.launch import cells as tcells
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer as tt
from repro_torch.models.common import tree_flatten, tree_leaves, tree_unflatten
from repro_torch.train import step as tstep

ROOT = Path(__file__).resolve().parents[1]
OPT_RTOL = 1e-6
LOSS_RTOL = 1e-3
GRAD_REL_L2 = 0.1
UPDATE_REL_L2 = 0.3
CONFIGS = ["llama3.2-1b", "mamba2-780m", "mixtral-8x7b"]


def _rng_tree(seed, scale=1.0):
    """A float32 tree with nested dicts and lists of odd shapes."""
    r = np.random.default_rng(seed)

    def a(*shape):
        return (r.standard_normal(shape) * scale).astype(np.float32)
    return {"w": a(5, 3), "blocks": [{"b": a(7), "k": a(2, 2, 3)}, {"b": a(7), "k": a(2, 2, 3)}],
            "a": a(1)}


def _t(tree):
    return tree_unflatten(tree_flatten(tree)[1],
                          [torch.from_numpy(np.array(x)) for x in tree_flatten(tree)[0]])


def _assert_tree_close(port, ref, rtol, atol=0.0):
    pl, rl = tree_leaves(port), jax.tree.leaves(ref)
    assert len(pl) == len(rl)
    for a, b in zip(pl, rl):
        np.testing.assert_allclose(np.asarray(a.detach() if hasattr(a, "detach") else a),
                                   np.asarray(b), rtol=rtol, atol=atol)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ------------------------------------------------------------------ trees
def test_tree_flatten_matches_jax_leaf_order():
    Pair = collections.namedtuple("Pair", ["z", "a"])
    tree = {"b": [1, (2, 3)], "a": {"y": 4, "x": Pair(5, [6, None, 7])}, "c": None}
    leaves, treedef = tree_flatten(tree)
    assert leaves == jax.tree.leaves(tree) == [5, 6, 7, 4, 1, 2, 3]
    back = tree_unflatten(treedef, leaves)
    assert back == tree and isinstance(back["a"]["x"], Pair)
    with pytest.raises(ValueError):
        tree_unflatten(treedef, leaves[:-1])
    with pytest.raises(ValueError):
        tree_unflatten(treedef, leaves + [8])


def test_adamw_state_leaf_order_matches_jax():
    params = _rng_tree(0)
    jl = jax.tree.leaves((params, jopt.adamw_init(params)))
    tl = tree_leaves((_t(params), topt.adamw_init(_t(params))))
    assert [np.shape(x) for x in jl] == [tuple(x.shape) for x in tl]
    assert tl[len(tree_leaves(params))].dtype == torch.int32  # the step, first


# -------------------------------------------------------------- optimizer
@pytest.mark.parametrize("warmup,total,min_ratio", [(10, 100, 0.1), (5, 30, 0.1),
                                                     (0, 50, 0.0), (7, 7, 0.2)])
def test_cosine_schedule_matches_reference(warmup, total, min_ratio):
    for s in range(101):
        want = float(jopt.cosine_schedule(jnp.asarray(s, jnp.int32), peak_lr=3e-4,
                                          warmup_steps=warmup, total_steps=total,
                                          min_ratio=min_ratio))
        got = topt.cosine_schedule(torch.tensor(s, dtype=torch.int32), peak_lr=3e-4,
                                   warmup_steps=warmup, total_steps=total,
                                   min_ratio=min_ratio)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=OPT_RTOL, atol=0)


def test_cosine_schedule_shape():
    lrs = [float(topt.cosine_schedule(torch.tensor(s), peak_lr=1.0, warmup_steps=10,
                                      total_steps=100)) for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1.0) < 1e-6
    assert lrs[-1] == pytest.approx(0.1, rel=1e-3)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_global_norm_and_clip_match_reference(max_norm):
    g = _rng_tree(1, scale=0.3)
    np.testing.assert_allclose(float(topt.global_norm(_t(g))), float(jopt.global_norm(g)),
                               rtol=OPT_RTOL)
    tc, tn = topt.clip_by_global_norm(_t(g), max_norm)
    jc, jn = jopt.clip_by_global_norm(g, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_RTOL)
    _assert_tree_close(tc, jc, OPT_RTOL)


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 3.0, "b": torch.ones(4) * 4.0}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert float(topt.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


@pytest.mark.parametrize("step,wd", [(0, 0.1), (7, 0.1), (3, 0.0)])
def test_adamw_update_matches_reference(step, wd):
    p, g = _rng_tree(2), _rng_tree(3, scale=0.01)
    mu, nu = _rng_tree(4, scale=0.01), jax.tree.map(np.abs, _rng_tree(5, scale=1e-4))
    lr = np.float32(3e-4)
    jst = jopt.AdamWState(step=jnp.asarray(step, jnp.int32), mu=mu, nu=nu)
    jp, jo = jopt.adamw_update(g, jst, p, lr=jnp.asarray(lr), weight_decay=wd)
    tp = _t(p)
    tst = topt.AdamWState(step=torch.tensor(step, dtype=torch.int32), mu=_t(mu), nu=_t(nu))
    np_, no = topt.adamw_update(_t(g), tst, tp, lr=torch.tensor(lr), weight_decay=wd)
    assert np_ is tp  # in place: the launcher hands its trees over
    assert int(no.step) == int(jo.step) == step + 1 and no.step.dtype == torch.int32
    _assert_tree_close(np_, jp, OPT_RTOL)
    _assert_tree_close(no.mu, jo.mu, OPT_RTOL)
    _assert_tree_close(no.nu, jo.nu, OPT_RTOL)


def test_adamw_decoupled_weight_decay():
    p = {"w": torch.ones(2)}
    st = topt.adamw_init(p)
    new_p, _ = topt.adamw_update({"w": torch.zeros(2)}, st, p, lr=torch.tensor(0.1),
                                 weight_decay=0.5)
    np.testing.assert_allclose(new_p["w"].numpy(), 1.0 - 0.05, rtol=1e-5)


# ------------------------------------------------------------------- loss
@pytest.fixture(scope="module")
def hidden_case():
    r = np.random.default_rng(6)
    h = (r.standard_normal((2, 32, 64))).astype(np.float32)
    w = (r.standard_normal((64, 256)) * 0.125).astype(np.float32)
    t = r.integers(0, 256, (2, 32)).astype(np.int32)
    jh = jnp.asarray(h).astype(jnp.bfloat16)
    th = torch.from_numpy(h).to(torch.bfloat16)
    return jh, th, w, t


@pytest.mark.parametrize("chunk", [8, 16, 32])
def test_chunked_xent_matches_reference_and_naive(hidden_case, chunk):
    jh, th, w, t = hidden_case
    want = float(jstep.chunked_softmax_xent(jh, jnp.asarray(w), jnp.asarray(t), chunk=chunk))
    got = tstep.chunked_softmax_xent(th, torch.from_numpy(w), torch.from_numpy(t), chunk=chunk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=2e-4)
    # the naive loss of bf16 logits, as tests/test_train.py takes it
    logits = (th @ torch.from_numpy(w).to(torch.bfloat16)).float()
    naive = (torch.logsumexp(logits, -1)
             - logits.gather(-1, torch.from_numpy(t).long()[..., None])[..., 0]).mean()
    np.testing.assert_allclose(float(got), float(naive), rtol=2e-4)


def test_chunked_xent_gradient_matches_naive(hidden_case):
    _, th, w, t = hidden_case
    tt_ = torch.from_numpy(t).long()

    def grads(loss_of):
        h = th.clone().requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        return torch.autograd.grad(loss_of(h, wt), (h, wt))

    def naive(h, wt):
        logits = (h.float() @ wt.to(h.dtype).float())
        return (torch.logsumexp(logits, -1) - logits.gather(-1, tt_[..., None])[..., 0]).mean()

    for a, b in zip(grads(lambda h, wt: tstep.chunked_softmax_xent(h, wt, tt_, chunk=8)),
                    grads(naive)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=2e-3)


def _zero_routers(params):
    for slot in params["blocks"]:
        if "router" in slot.get("ffn", {}):
            slot["ffn"]["router"] = np.zeros_like(slot["ffn"]["router"])
    return params


def _batch(cfg, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)).long() if v.dtype == np.int32
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    name = request.param
    jcfg, tcfg = jget(name).reduced(), tget(name).reduced()
    params = _zero_routers(jax.tree.map(np.asarray, jt.init(jcfg, jax.random.PRNGKey(0))))
    return jcfg, tcfg, params, _batch(jcfg, 2, 32, 1)


def _port_params(tcfg, params):
    tp = convert.lm_params_from_numpy(tcfg, params, "cpu")
    for leaf in tree_leaves(tp):
        leaf.requires_grad_()
    return tp


def _port_grads(tcfg, tp, batch, **kw):
    loss, metrics = tstep.loss_fn(tcfg, tp, _tbatch(batch), **kw)
    return loss, metrics, torch.autograd.grad(loss, tree_leaves(tp))


def test_loss_fn_grads_match_reference(model):
    jcfg, tcfg, params, batch = model
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: jstep.loss_fn(jcfg, p, b, loss_chunk=8)[0]))(params, batch)
    tl, _, tg = _port_grads(tcfg, _port_params(tcfg, params), batch, loss_chunk=8)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=LOSS_RTOL)
    rels = [_rel_l2(a.numpy(), b) for a, b in zip(tg, jax.tree.leaves(jg))]
    assert len(rels) == len(jax.tree.leaves(params))
    assert max(rels) <= GRAD_REL_L2, rels


def test_train_step_matches_reference(model):
    jcfg, tcfg, params, batch = model
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    js = jax.jit(jstep.make_train_step(jcfg, **kw))
    # step 0 takes learning rate 0: the parameters stay, the moments fill
    p0, o0, _ = js(params, jopt.adamw_init(params), batch)
    p0, o0 = jax.tree.map(np.asarray, (p0, o0))
    jp, jo, jm = js(p0, o0, batch)
    tp = _port_params(tcfg, p0)
    to = convert.adamw_state_from_numpy(tcfg, o0, "cpu")
    np_, no, tm = tstep.make_train_step(tcfg, **kw)(tp, to, _tbatch(batch))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-2)
    assert float(tm["lr"]) == float(jm["lr"]) and int(no.step) == int(jo.step) == 2
    assert set(tm) == set(jm)
    for a, b, c in zip(tree_leaves(convert.tree_to_numpy(np_)), jax.tree.leaves(jp),
                       jax.tree.leaves(p0)):
        assert _rel_l2(a - c, np.asarray(b) - c) <= UPDATE_REL_L2


def test_remat_is_bitwise(model):
    _, tcfg, params, batch = model
    tp = _port_params(tcfg, params)
    l1, m1, g1 = _port_grads(tcfg, tp, batch, remat=True, loss_chunk=16)
    l0, m0, g0 = _port_grads(tcfg, tp, batch, remat=False, loss_chunk=16)
    assert torch.equal(l1, l0) and torch.equal(m1["moe_aux"], m0["moe_aux"])
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


def test_forward_return_hidden_and_head_weight(model):
    _, tcfg, params, batch = model
    tp = convert.lm_params_from_numpy(tcfg, params, "cpu")
    toks = torch.from_numpy(batch["inputs"]).long()
    with torch.no_grad():
        logits, aux = tt.forward(tcfg, tp, toks, impl="plain")
        hidden, aux_h = tt.forward(tcfg, tp, toks, impl="plain", return_hidden=True,
                                   remat=True)
    assert hidden.shape == toks.shape + (tcfg.d_model,)
    assert torch.equal(hidden @ tt.head_weight(tcfg, tp).to(hidden.dtype), logits)
    assert torch.equal(aux, aux_h)


@pytest.mark.parametrize("name", ["llama3.2-1b", "qwen2-vl-2b"])
def test_accumulation_equivalence(name):
    """accum=2 gives the update of accum=1; qwen2-vl's mrope streams
    (3, B, S) split on their batch axis."""
    cfg = tget(name).reduced()
    gen = torch.Generator().manual_seed(0)
    params = tt.init(cfg, gen)
    batch = tcells.make_inputs(cfg, TShape("t", 32, 4, "train"), gen)
    outs = []
    for accum in (1, 2):
        p = tree_unflatten(tree_flatten(params)[1],
                           [x.clone().requires_grad_() for x in tree_leaves(params)])
        p, _, m = tstep.make_train_step(cfg, total_steps=10, accum=accum)(
            p, topt.adamw_init(p), batch)
        outs.append((p, m))
    worst = max(float((a - b).detach().abs().max())
                for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[1][0])))
    assert worst < 5e-4, worst
    np.testing.assert_allclose(float(outs[1][1]["loss"]), float(outs[0][1]["loss"]),
                               rtol=LOSS_RTOL)


def test_loss_decreases():
    cfg = tget("llama3.2-1b").reduced()
    gen = torch.Generator().manual_seed(0)
    params = tt.init(cfg, gen)
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    batch = tcells.make_inputs(cfg, TShape("t", 32, 4, "train"), gen)
    step = tstep.make_train_step(cfg, peak_lr=1e-3, total_steps=30, warmup_steps=2)
    opt = topt.adamw_init(params)
    losses = []
    for _ in range(12):  # the same batch: it must overfit
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses


def test_kernel_impl_refused():
    cfg = tget("llama3.2-1b").reduced()
    with pytest.raises(ValueError, match="ROADMAP"):
        tstep.make_train_step(cfg, impl="kernel")
    with pytest.raises(ValueError, match="ROADMAP"):
        tstep.loss_fn(cfg, {}, {}, impl="kernel")


# ----------------------------------------------------- inputs, checkpoints
@pytest.mark.parametrize("name", list_configs())
def test_train_inputs_and_accum_match_reference(name):
    jcfg, tcfg = jget(name).reduced(), tget(name).reduced()
    shape = ShapeSpec("t", 32, 4, "train")
    want = jcells.input_specs(jcfg, shape)
    tshape = TShape("t", 32, 4, "train")
    got = tcells.input_specs(tcfg, tshape)
    assert list(got) == list(want)
    assert all(tuple(got[k][0]) == tuple(want[k].shape) for k in got)
    assert tcells.default_accum(tget(name), tshape) == jcells.default_accum(jget(name), shape)
    assert tcells.default_accum(tget(name), TShape("p", 32, 4, "prefill")) == 1


@pytest.mark.parametrize("name", ["llama3.2-1b", "mamba2-780m"])
def test_reference_checkpoint_restores_into_port(tmp_path, name):
    """(params, adamw_init(params)) saved by the JAX package restores through
    ``restore_tree``; the port's save restores through the JAX package's."""
    jcfg, tcfg = jget(name).reduced(), tget(name).reduced()
    params = jt.init(jcfg, jax.random.PRNGKey(3))
    opt = jopt.adamw_init(params)
    opt = opt._replace(step=jnp.asarray(4, jnp.int32),
                       mu=jax.tree.map(lambda x: x * 0.5, params))
    jckpt.save(tmp_path / "ref", 7, (params, opt))
    tmpl = tlaunch.build_state(tcfg, torch.device("cpu"), 0)
    (tp, to), step = store.restore_tree(tmp_path / "ref", tmpl)
    assert step == 7 and isinstance(to, topt.AdamWState)
    assert to.step.dtype == torch.int32 and int(to.step) == 4
    assert all(x.requires_grad for x in tree_leaves(tp))
    for a, b in zip(tree_leaves((tp, to)), jax.tree.leaves((params, opt))):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    carried = convert.adamw_state_from_numpy(tcfg, jax.tree.map(np.asarray, opt), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(carried), tree_leaves(to)))
    # and back: the port's checkpoint through the JAX package's restore
    store.save_tree(tmp_path / "port", 9, (tp, to))
    (rp, ro), step = jckpt.restore(tmp_path / "port", (params, opt))
    assert step == 9
    for a, b in zip(jax.tree.leaves((rp, ro)), jax.tree.leaves((params, opt))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="leaves"):
        store.restore_tree(tmp_path / "ref", tmpl[0])


# --------------------------------------------------------------- launcher
# steps of the launcher runs: enough after the first checkpoint (step 2)
# that the kill lands before the run ends
TRAIN_STEPS = 12
TRAIN_ARGS = ["--arch", "llama3.2-1b", "--d-model", "64", "--layers", "2", "--seq", "32",
              "--batch", "2", "--steps", str(TRAIN_STEPS), "--log-every", "1",
              "--device", "cpu"]


def _launch(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          capture_output=True, text=True, timeout=300, env=env, cwd=ROOT, **kw)


def _losses(out: str) -> dict:
    return {int(ln.split()[2]): ln.split()[4] for ln in out.splitlines()
            if ln.startswith("[train] step")}


def test_launcher_runs_and_resumes_bitwise(tmp_path):
    """An uninterrupted run; a run killed after its first checkpoint; the
    same command again, which resumes from the newest committed step and
    gives the uninterrupted run's losses and final state bit for bit."""
    full = _launch(TRAIN_ARGS + ["--ckpt-dir", str(tmp_path / "full"), "--ckpt-every", "100"])
    assert full.returncode == 0, full.stderr[-2000:]
    want = _losses(full.stdout)
    assert sorted(want) == list(range(TRAIN_STEPS)) and "[train] loss" in full.stdout

    cmd = TRAIN_ARGS + ["--ckpt-dir", str(tmp_path / "run"), "--ckpt-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *cmd],
                            stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    try:
        for line in proc.stdout:
            if line.startswith("[train] checkpoint @"):
                break
    finally:
        proc.kill()
        proc.wait()
    first = store.latest_step(tmp_path / "run")
    assert first is not None and first < TRAIN_STEPS

    again = _launch(cmd)
    assert again.returncode == 0, again.stderr[-2000:]
    assert f"auto-resumed from step {first}" in again.stdout
    got = _losses(again.stdout)
    assert sorted(got) == list(range(first, TRAIN_STEPS))
    assert all(got[s] == want[s] for s in got), (got, want)
    final_full, _ = store.restore(tmp_path / "full", TRAIN_STEPS)
    final_run, _ = store.restore(tmp_path / "run", TRAIN_STEPS)
    assert all(np.array_equal(a, b) for a, b in zip(final_full, final_run))


def test_launcher_refuses_a_mesh_and_defaults_to_the_card(capsys):
    """In a world of one, ``--data 2 --model 2`` clamps to a 1x1 mesh and
    gives the meshless losses, and leaves no process group behind; without
    ``--device`` the launcher runs on the card (raises without one)."""
    args = [a if a != str(TRAIN_STEPS) else "3" for a in TRAIN_ARGS]
    assert tlaunch.main(args) == 0
    want = _losses(capsys.readouterr().out)
    assert tlaunch.main(args + ["--data", "2", "--model", "2"]) == 0
    out = capsys.readouterr().out
    assert "mesh data=1xmodel=1 (1 ranks, gloo)" in out
    assert _losses(out) == want and sorted(want) == [0, 1, 2]
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        no_device = [a for a in TRAIN_ARGS if a not in ("--device", "cpu")]
        with pytest.raises(RuntimeError, match="cuda"):
            tlaunch.main(no_device)


def test_train_lm_example_passes_its_flags(monkeypatch):
    from repro_torch.examples import train_lm

    seen = []
    monkeypatch.setattr(train_lm, "train_main", lambda argv: seen.append(argv) or 0)
    assert train_lm.main(["--steps", "3", "--ckpt-dir", "x", "--device", "cpu"]) == 0
    argv = seen[0]
    flags = dict(zip(argv[::2], argv[1::2]))
    assert flags == {"--arch": "llama3.2-1b", "--d-model": "512", "--layers": "12",
                     "--seq": "512", "--batch": "8", "--steps": "3", "--ckpt-dir": "x",
                     "--ckpt-every": "100", "--log-every": "20", "--device": "cpu"}
