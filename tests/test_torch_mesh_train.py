"""The LM trained on a (data, model) mesh of ranks (``launch.train --data /
--model``: DTensor masters and moments placed by ``params_sharding``, the
step under ``ctx.use_rules``) against its meshless run, on the CPU.

* Spawned gloo worlds of 2 (meshes 2x1 and 1x2) and 4 (2x2), a
  ``FileStore`` under ``tmp_path`` (no port), every group with a timeout
  and every join with a deadline, run ``launch.train.main --device cpu``
  for reduced llama3.2-1b, mamba2-780m and mixtral-8x7b (d_model 64, 2
  layers, seq 32, batch 4, 4 steps).  Each loss the mesh's first rank logs
  must lie within ``LOSS_TOL`` = 1e-3 of the meshless run's (the readings:
  up to 4.8e-4; steps 0 and 1 share their parameters and agree within
  1e-6, and from the first update on the bf16 rounding of products whose
  sums are split over ranks moves Adam's updates: each rank's products are
  the meshless ones on its shards, the sums across ranks run in float32),
  and each rank's local state bytes must be
  exactly what the specs imply (each split dim divided by its axes).
  mixtral's mesh runs take the meshless run's routing (each MoE layer's
  experts, recorded in call order, recomputations included; gates and
  queue positions from the run's own probabilities), as ``chip_smoke.py``
  replays the plain path's routing into the kernel path: from the second
  update on, a bf16 ulp of difference in a router weight can flip a
  near-tie to another expert, an O(1) change of that token's output (a
  reading: 4.5e-3 at 2x2, step 3, without the replay).
* Step 0's gradients (the masters drawn from the launcher's seed, the MoE
  routers zeroed so that ties fix the experts on every side, as
  ``tests/test_torch_train.py`` does; the launcher's step-0 batch), each
  gathered whole with ``full_tensor``: each must come back in its
  parameter's placements; each leaf within a relative L2 of
  ``GRAD_REL_L2`` = 0.1 of the JAX package's ``loss_fn`` gradient on the
  same state and batch, and the loss within ``LOSS_RTOL`` = 1e-3 of its
  loss (``tests/test_torch_train.py``'s bounds); each leaf within
  ``MESH_GRAD_REL_L2`` = 0.02 of the meshless port's gradient and the
  global norm (the one clipping reads, over the DTensor gradients) within
  rtol ``GNORM_RTOL`` = 2e-3 of the meshless one (the readings: leaves up
  to 7.9e-3 and norms up to 5.6e-4, mamba2 at 1x2 and 2x2, where the CPU's
  bf16 products differ from the float32 sums of the split ones by an ulp;
  the other runs 8e-5 and 1.2e-6).  A gradient summed twice, halved, or
  missing a rank's rows moves its leaf by 0.5 or more.
* A checkpoint written at 2x1 resumes at 1x2 through ``restore_resharded``
  and repeats the unbroken 2x1 run's losses within ``LOSS_TOL``.
* llama's runs pass ``--count-comm``: every rank prints the last step's
  collective calls and bytes (``sharding.count_collectives``), no other's;
  the counter counts one all-gather as one call of its output's bytes.
* One step each of qwen2-vl-2b and whisper-medium (reduced) at 2x1: their
  vision embeddings, mrope streams and frames go through
  ``input_sharding``.
* ``psum_compressed`` in the worlds of 2 and 4 equals the JAX package's
  ``compress`` outputs summed by its formula (int32 sum, max scale, / n),
  bit for bit.
* The launcher in a world of one clamps ``--data 2 --model 2`` to 1x1 and
  gives the meshless losses (``tests/test_torch_train.py``).
"""
from __future__ import annotations

import contextlib
import datetime
import io
import pickle
import re
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLDS = {2: ((2, 1), (1, 2)), 4: ((2, 2),)}
CONFIGS = ("llama3.2-1b", "mamba2-780m", "mixtral-8x7b")
EXTRAS = ("qwen2-vl-2b", "whisper-medium")  # one step at 2x1
STEPS = 4
LOSS_TOL = 1e-3
LOSS_RTOL = 1e-3
GRAD_REL_L2 = 0.1
MESH_GRAD_REL_L2 = 0.02
GNORM_RTOL = 2e-3
GROUP_TIMEOUT_S = 60.0
JOIN_DEADLINE_S = 300.0
_STEP = re.compile(r"^\[train\] step\s+(\d+) loss (\S+) ")
_BYTES = re.compile(r"^\[train\] rank (\d+) local state bytes (\d+)$")
_COMM = re.compile(r"^\[train\] (?:rank \d+ )?step\s+(\d+) .*comm (\d+) calls (\d+) B$")


def _argv(name: str, steps: int = STEPS) -> list:
    return ["--arch", name, "--d-model", "64", "--layers", "2", "--seq", "32", "--batch", "4",
            "--steps", str(steps), "--log-every", "1", "--device", "cpu"]


def _given_route(probs, topi, topk, capacity_factor):
    """``moe._route`` with the experts ``topi`` given: gates and queue
    positions from the run's own probabilities."""
    from repro_torch.models import moe

    B, S, E = probs.shape
    C = moe.moe_capacity(S, E, topk, capacity_factor)
    topw = torch.gather(probs, -1, topi)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    onehot = torch.nn.functional.one_hot(topi.reshape(B, S * topk), E)
    pos = ((torch.cumsum(onehot, dim=1) - onehot) * onehot).sum(-1)
    return moe.Routing(probs, topi, topw, pos, pos < C, C)


def _run(argv: list, routes=None, rows=slice(None)) -> str:
    """``launch.train.main(argv)``'s standard output.  ``routes``: a list
    to record every MoE routing's experts into, in call order, or a
    recorded list whose experts (this rank's ``rows`` of the batch) each
    routing takes in turn."""
    from repro_torch.launch import train
    from repro_torch.models import moe

    real, calls = moe._route, []

    def route(probs, topk, capacity_factor):
        if routes is None:
            return real(probs, topk, capacity_factor)
        calls.append(1)
        if isinstance(routes, _Record):
            r = real(probs, topk, capacity_factor)
            routes.append(r.topi.clone())
            return r
        return _given_route(probs, routes[len(calls) - 1][rows], topk, capacity_factor)

    out = io.StringIO()
    moe._route = route
    try:
        with contextlib.redirect_stdout(out):
            assert train.main(argv) == 0
    finally:
        moe._route = real
    assert routes is None or isinstance(routes, _Record) or len(calls) == len(routes)
    return out.getvalue()


class _Record(list):
    """A routing record being written."""


def _losses(text: str) -> dict:
    return {int(m.group(1)): float(m.group(2))
            for m in map(_STEP.match, text.splitlines()) if m}


def _grads(seed: int) -> dict:
    r = np.random.default_rng(seed)
    return {"a": (r.standard_normal((6, 5)) * (seed + 1)).astype(np.float32),
            "b": [r.standard_normal(9).astype(np.float32) * 1e-2]}


def _zero_routers(params) -> None:
    for slot in params["blocks"]:
        router = slot.get("ffn", {}).get("router")
        if router is not None:
            with torch.no_grad():
                (router.to_local() if hasattr(router, "to_local") else router).zero_()


def _step0_grads(name: str, mesh=None):
    """(loss, global norm, each gradient whole as numpy, every gradient in
    its parameter's placements) of step 0 from the launcher's state (the
    routers zeroed) and batch, on ``mesh`` or meshless."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs.base import get_config
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import train
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import global_norm
    from repro_torch.train import step

    cfg = get_config(name).reduced(d_model=64, n_layers=2)
    dev = torch.device("cpu")
    params, _ = train.build_state(cfg, dev, 0, mesh)
    _zero_routers(params)
    batch_fn, placed = train.batch_source(cfg, 32, 4, 0, dev, mesh)
    if mesh is None:
        scope = contextlib.nullcontext()
    else:
        scope = contextlib.ExitStack()
        scope.enter_context(ctx.use_rules(mesh, sharding.make_rules(mesh)))
        scope.enter_context(implicit_replication())
    with scope:
        loss, _, grads = step.loss_and_grads(cfg, params, placed(batch_fn(0)))
        norm = global_norm(grads)
    whole = (lambda x: x.full_tensor()) if mesh is not None else (lambda x: x)
    same = mesh is None or all(tuple(g.placements) == tuple(p.placements)
                               for g, p in zip(grads, tree_leaves(params)))
    return (float(whole(loss)), float(whole(norm)), [whole(g).numpy() for g in grads], same)


# ------------------------------------------------------------------ the ranks
def _rank_main(rank: int, world: int, store: str, out: str, shapes, routes_file: str) -> None:
    """One rank of a spawned gloo world: every config on every mesh shape,
    the 2x1 -> 1x2 resume, the extras, and ``psum_compressed``."""
    from repro_torch.distributed import compression as tcomp
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    routes = pickle.load(open(routes_file, "rb"))
    try:
        got = {}
        ckpt = Path(out) / "ckpt"
        for d, m in shapes:
            mesh = ["--data", str(d), "--model", str(m)]
            rows = slice((rank // m) * 4 // d, (rank // m + 1) * 4 // d)  # batch 4
            for name in CONFIGS:
                extra = ["--count-comm"] if name == "llama3.2-1b" else []
                if (d, m) == (2, 1) and name == "llama3.2-1b":
                    extra += ["--ckpt-dir", str(ckpt), "--ckpt-every", "2"]
                got[((d, m), name)] = _run(_argv(name) + mesh + extra, routes.get(name), rows)
            dm = make_test_mesh(d, m, device_type="cpu")
            for name in CONFIGS:
                got[((d, m), name, "grads")] = _step0_grads(name, dm)
            if (d, m) == (2, 1):
                for name in EXTRAS:
                    got[((d, m), name)] = _run(_argv(name, 1) + mesh)
        if (1, 2) in shapes:  # a crash after step 2 of the 2x1 run: resume at 1x2
            if rank == 0:
                shutil.rmtree(ckpt / f"step_{STEPS:09d}")
            dist.barrier()
            got["resume"] = _run(_argv("llama3.2-1b") + ["--data", "1", "--model", "2",
                                                          "--ckpt-dir", str(ckpt)])
        # one known collective under the counter: an all-gather of (2, 3)
        # float32 rows from every rank
        from torch.distributed.tensor import DTensor, Replicate, Shard

        from repro_torch.distributed import sharding

        line = make_test_mesh(world, 1, device_type="cpu")
        x = DTensor.from_local(torch.ones(2, 3), line, [Shard(0), Replicate()])
        sharding.COMM.reset()
        with sharding.count_collectives():
            x.redistribute(line, [Replicate(), Replicate()])
        got["count"] = (sharding.COMM.calls, sharding.COMM.bytes, dict(sharding.COMM.by_op))
        g = _grads(rank)
        g = {"a": torch.from_numpy(g["a"]), "b": [torch.from_numpy(g["b"][0])]}
        c, _ = tcomp.compress(g, tcomp.ef_init(g))
        summed = tcomp.psum_compressed(c, None, world)
        got["psum"] = [summed["a"].numpy(), summed["b"][0].numpy()]
        with open(f"{out}/rank{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def meshless(tmp_path_factory):
    """({name: {step: loss}} of the meshless runs, the file of mixtral's
    recorded routings)."""
    routes = _Record()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: the CPU's GEMMs round alike
    try:
        out = {name: _losses(_run(_argv(name), routes if name == "mixtral-8x7b" else None))
               for name in CONFIGS}
        out.update({name: _losses(_run(_argv(name, 1))) for name in EXTRAS})
        out.update({(name, "grads"): _step0_grads(name) for name in CONFIGS})
    finally:
        torch.set_num_threads(threads)
    path = tmp_path_factory.mktemp("routes") / "routes.pkl"
    with open(path, "wb") as f:
        pickle.dump({"mixtral-8x7b": list(routes)}, f)
    return out, str(path)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, meshless):
    """{world: [per-rank outputs]}: both worlds spawned at once, each held to
    the deadline (its ranks killed past it or when one fails)."""
    runs = {}
    for world, shapes in WORLDS.items():
        tmp = tmp_path_factory.mktemp(f"train_world{world}")
        ctx = mp.start_processes(_rank_main, args=(world, str(tmp / "store"), str(tmp), shapes,
                                                   meshless[1]),
                                 nprocs=world, join=False, start_method="spawn")
        runs[world] = (ctx, tmp)
    deadline = time.monotonic() + JOIN_DEADLINE_S
    try:
        for world, (ctx, _) in runs.items():
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise AssertionError(f"world of {world} ranks passed its "
                                         f"{JOIN_DEADLINE_S} s deadline")
    finally:
        for ctx, _ in runs.values():
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
    return {world: [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(world)]
            for world, (_, tmp) in runs.items()}


def _world_of(shape) -> int:
    return shape[0] * shape[1]


def _spec_bytes(name: str, shape) -> int:
    """The local bytes of (params, AdamW state) the specs imply on a
    ``shape`` mesh: each float32 leaf's numel divided by the sizes of the
    axes its spec names, three times (master, mu, nu), plus the int32 step."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.distributed import MeshLayout
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer

    cfg = get_config(name).reduced(d_model=64, n_layers=2)
    sizes = dict(zip(("data", "model"), shape))
    specs, decls = [], []

    def walk(s, t):
        if isinstance(s, tuple):
            specs.append(s)
            decls.append(t)
        elif isinstance(s, dict):
            for k in s:
                walk(s[k], t[k])
        else:
            for a, b in zip(s, t):
                walk(a, b)

    tmpl = transformer.param_template(cfg)
    walk(sharding.spec_tree(tmpl, MeshLayout(("data", "model"), shape)), tmpl)
    total = 0
    for spec, decl in zip(specs, decls):
        n = int(np.prod(decl.shape))
        for entry in spec:
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                n //= sizes.get(ax, 1) if ax else 1
        total += 3 * 4 * n
    return total + 4


MESHES = [s for shapes in WORLDS.values() for s in shapes]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_losses_equal_the_meshless_run(worlds, meshless, shape, name):
    ranks = worlds[_world_of(shape)]
    got = _losses(ranks[0][(shape, name)])
    want = meshless[0][name]
    assert sorted(got) == list(range(STEPS)) == sorted(want)
    gaps = {s: abs(got[s] - want[s]) for s in got}
    assert max(gaps.values()) <= LOSS_TOL, (shape, name, gaps)
    assert all(not _losses(r[(shape, name)]) for r in ranks[1:])  # only the lead logs


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_holds_only_its_shards(worlds, shape, name):
    ranks = worlds[_world_of(shape)]
    want = _spec_bytes(name, shape)
    seen = {}
    for r in ranks:
        for m in map(_BYTES.match, r[(shape, name)].splitlines()):
            if m:
                seen[int(m.group(1))] = int(m.group(2))
    assert seen == {r: want for r in range(len(ranks))}
    if shape != (1, 1):
        assert want < _spec_bytes(name, (1, 1))


@pytest.fixture(scope="module")
def reference_grads():
    """{name: (loss, [gradient leaves])} of the JAX package's ``loss_fn`` on
    the state and batch of ``_step0_grads``."""
    import jax

    from repro.configs.base import get_config as jget
    from repro.models import transformer as jt
    from repro.train import step as jstep
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train

    out = {}
    for name in CONFIGS:
        cfg = get_config(name).reduced(d_model=64, n_layers=2)
        jcfg = jget(name).reduced(d_model=64, n_layers=2)
        params, _ = train.build_state(cfg, torch.device("cpu"), 0)
        _zero_routers(params)
        leaves = jax.tree.leaves(convert.tree_to_numpy(params))
        shapes = jax.eval_shape(lambda: jt.init(jcfg, jax.random.PRNGKey(0)))
        jp = jax.tree.unflatten(jax.tree.structure(shapes), leaves)
        batch = train.batch_source(cfg, 32, 4, 0, torch.device("cpu"))[0](0)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: jstep.loss_fn(jcfg, p, b)[0]))(jp, dict(batch))
        out[name] = (float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)])
    return out


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_step0_gradients_match_the_reference(worlds, meshless, reference_grads, shape, name):
    loss, norm, grads, same = worlds[_world_of(shape)][0][(shape, name, "grads")]
    m_loss, m_norm, m_grads, _ = meshless[0][(name, "grads")]
    j_loss, j_grads = reference_grads[name]
    assert same, "a gradient came back in other placements than its parameter's"
    assert len(grads) == len(m_grads) == len(j_grads)
    assert abs(loss - j_loss) <= LOSS_RTOL * abs(j_loss), (loss, j_loss)
    to_jax = [_rel_l2(a, b) for a, b in zip(grads, j_grads)]
    assert max(to_jax) <= GRAD_REL_L2, to_jax
    to_meshless = [_rel_l2(a, b) for a, b in zip(grads, m_grads)]
    assert max(to_meshless) <= MESH_GRAD_REL_L2, to_meshless
    assert abs(norm - m_norm) <= GNORM_RTOL * m_norm, (norm, m_norm)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_count_comm_counts_the_last_steps_collectives(worlds, shape):
    """``--count-comm`` (llama's runs): every rank prints the last step's
    collective calls and bytes, and no other step's."""
    for r in worlds[_world_of(shape)]:
        seen = [tuple(map(int, m.groups())) for m in map(_COMM.match,
                                                          r[(shape, "llama3.2-1b")].splitlines())
                if m]
        assert len(seen) == 1 and seen[0][0] == STEPS - 1, seen
        assert seen[0][1] > 0 and seen[0][2] > 0, seen


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_count_collectives_counts_each_collective_once(worlds, world):
    """One all-gather of (2, 3) float32 rows from every rank: one call, its
    whole output's bytes (the op's autograd wrapper is not counted)."""
    n = world * 2 * 3 * 4
    for r in worlds[world]:
        assert r["count"] == (1, n, {"all_gather_into_tensor": [1, n]}), r["count"]


def test_checkpoint_at_2x1_resumes_at_1x2(worlds):
    ranks = worlds[2]
    text = ranks[0]["resume"]
    assert "auto-resumed from step 2" in text
    got, want = _losses(text), _losses(ranks[0][((2, 1), "llama3.2-1b")])
    assert sorted(got) == [2, 3]
    assert max(abs(got[s] - want[s]) for s in got) <= LOSS_TOL, (got, want)
    assert all("auto-resumed from step 2" not in r["resume"] for r in ranks[1:])


@pytest.mark.parametrize("name", EXTRAS)
def test_extra_inputs_go_through_input_sharding(worlds, meshless, name):
    got = _losses(worlds[2][0][((2, 1), name)])
    assert sorted(got) == [0] and abs(got[0] - meshless[0][name][0]) <= LOSS_TOL


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_psum_compressed_equals_the_reference_formula(worlds, world):
    from repro.distributed import compression as jcomp

    comps = [jcomp.compress(_grads(r), jcomp.ef_init(_grads(r)))[0] for r in range(world)]
    want = []
    for leaf in range(2):
        qs = [np.asarray(jax_leaf(c.q, leaf)).astype(np.int32) for c in comps]
        scale = max(np.float32(np.asarray(jax_leaf(c.scale, leaf))) for c in comps)
        want.append(sum(qs).astype(np.float32) * scale / np.float32(world))
    for r in worlds[world]:
        for a, b in zip(r["psum"], want):
            assert a.dtype == np.float32 and a.tobytes() == b.astype(np.float32).tobytes()


def jax_leaf(tree, i):
    return tree["a"] if i == 0 else tree["b"][0]
