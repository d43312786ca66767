"""LM serving on a (data, model) mesh of ranks (``launch.cells.build_step``:
prefill and decode with DTensor parameters, inputs and caches) against the
JAX package and the meshless port, on the CPU.

* One spawned gloo world of 4 ranks (a ``FileStore`` under ``tmp_path``,
  no port; every group with a timeout, the join with a deadline) runs the
  meshes 2x2 and 1x4 for reduced llama3.2-1b, mamba2-780m and
  mixtral-8x7b (the routers zeroed, so that ties fix the experts on every
  side, as ``tests/test_torch_families.py`` does), B=4: a prefill of
  S=32 and 4 decode steps against a cache of 64 rows (the meshless port's
  padded prefill cache, cut to the decode bundle's ``cache_spec``
  placements), each step's token at positions 32..35.
* Logits (gathered with ``full_tensor``) lie within ``LOGIT_TOL`` = 0.1 of
  the JAX package's meshless ``prefill`` / ``pad_cache`` / ``decode_step``
  on the same weights (carried by ``convert.py``; bf16 in both
  frameworks, ``tests/test_torch_lm.py``'s bound).  Against the meshless
  port the same run is held with float32 activations
  (``transformer.ACT_DTYPE``), within ``MESH_TOL`` = 1e-3: in bf16 a
  row-parallel sum taken across ranks in float32 and rounded once can
  round a logit one bf16 ulp (2^-7 at |logit| ~ 1) from the meshless GEMM's
  (a reading: llama 2x2 prefill, one logit).
* Each rank holds only its ``cache_spec`` shards: every prefill cache leaf
  comes back in ``cache_spec``'s placements with the local shape they
  imply, and the decode steps update the cache in place (the same local
  storage, the meshless run's values within ``MESH_TOL`` in float32).
* A 1x1 mesh in a world of one gives the meshless logits bit for bit.
* ``sharding.count_collectives`` counts plain ``c10d`` calls once each.
* Fault: reduced llama3.2-1b (KV=2) and qwen2-vl-2b (KV=2) train at
  ``--data 1 --model 4``, where the KV heads do not divide the model axis
  (the head split used to raise in DTensor's reshape), within ``LOSS_TOL``
  = 1e-3 of the meshless run's losses.
"""
from __future__ import annotations

import contextlib
import datetime
import io
import pickle
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
SHAPES = ((2, 2), (1, 4))
CONFIGS = ("llama3.2-1b", "mamba2-780m", "mixtral-8x7b")
TRAIN_CONFIGS = ("llama3.2-1b", "qwen2-vl-2b")
B, S, CAP, STEPS = 4, 32, 64, 4
LOGIT_TOL = 0.1
MESH_TOL = 1e-3
LOSS_TOL = 1e-3
GROUP_TIMEOUT_S = 60.0
JOIN_DEADLINE_S = 300.0
DTYPES = ("bf16", "f32")
_STEP = re.compile(r"^\[train\] step\s+(\d+) loss (\S+) ")


def _train_argv(name: str) -> list:
    return ["--arch", name, "--d-model", "64", "--layers", "2", "--seq", "32", "--batch", "4",
            "--steps", "4", "--log-every", "1", "--device", "cpu"]


def _losses(text: str) -> dict:
    return {int(m.group(1)): float(m.group(2))
            for m in map(_STEP.match, text.splitlines()) if m}


def _train(argv: list) -> str:
    from repro_torch.launch import train

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train.main(argv) == 0
    return out.getvalue()


@contextlib.contextmanager
def _act_dtype(dtype: str):
    from repro_torch.models import transformer as tt

    old = tt.ACT_DTYPE
    tt.ACT_DTYPE = torch.float32 if dtype == "f32" else torch.bfloat16
    try:
        yield
    finally:
        tt.ACT_DTYPE = old


def _zero_routers(tree) -> None:
    for slot in tree["blocks"]:
        if "router" in slot.get("ffn", {}):
            slot["ffn"]["router"] = np.zeros_like(slot["ffn"]["router"])


def _meshless(name: str, np_params, toks: np.ndarray, dtype: str):
    """The meshless port: (prefill logits, prefill cache, the cache padded
    to CAP, [decode logits], the cache after the decode steps)."""
    from repro_torch import convert
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tt

    cfg = get_config(name).reduced()
    params = convert.lm_params_from_numpy(cfg, np_params, "cpu")
    t = torch.from_numpy(toks).long()
    with _act_dtype(dtype):
        logits, cache = tt.prefill(cfg, params, t[:, :S], impl="plain")
        padded = tt.pad_cache(cfg, cache, CAP)
        run = [{k: v.clone() for k, v in slot.items()} for slot in padded]
        dec = []
        for i in range(STEPS):
            lg, run = tt.decode_step(cfg, params, run, t[:, S + i:S + i + 1],
                                     torch.full((B,), S + i))
            dec.append(lg)
    return logits, cache, padded, dec, run


# ------------------------------------------------------------------ the ranks
def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _rank_serve(name, mesh, np_params, toks, padded, dtype):
    """One config's prefill and decode steps through ``build_step`` on
    ``mesh``: logits whole, the caches whole, and whether every cache leaf
    is held as ``cache_spec`` says (placements and local shapes) and was
    updated in place."""
    from repro_torch import convert
    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch import cells

    cfg = get_config(name).reduced()
    params = convert.lm_params_from_numpy(cfg, np_params, "cpu")
    t = torch.from_numpy(toks).long()
    out = {}
    with _act_dtype(dtype), ctx.use_rules(mesh, sharding.make_rules(mesh)):
        pre = cells.build_step(cfg, ShapeSpec("p", S, B, "prefill"), mesh)
        logits, cache = pre.fn(*cells.distribute_args(pre, (params, {"tokens": t[:, :S]})))
        out["prefill"] = _full(logits).float().numpy()
        out["prefill_cache"] = [{k: _full(v).float().numpy() for k, v in s.items()}
                                for s in cache]
        out["prefill_layout"] = _layout_ok(cache, pre.out_placements[1], mesh)
        dec = cells.build_step(cfg, ShapeSpec("d", CAP, B, "decode"), mesh)
        whole = [{k: v.clone() for k, v in s.items()} for s in padded]
        p, run, _ = cells.distribute_args(dec, (params, whole, {"token": t[:, :1],
                                                                "pos": t[:, 0]}))
        local = [{k: v.to_local().data_ptr() for k, v in s.items()} for s in run]
        logits = []
        for i in range(STEPS):
            batch = {"token": t[:, S + i:S + i + 1], "pos": torch.full((B,), S + i)}
            b = cells.map_placed(lambda x, pl: ctx.distribute(x, mesh, pl), batch,
                                 dec.in_placements[2])
            lg, run2 = dec.fn(p, run, b)
            assert run2 is run
            logits.append(_full(lg).float().numpy())
        out["decode"] = logits
        out["decode_cache"] = [{k: _full(v).float().numpy() for k, v in s.items()} for s in run]
        out["decode_layout"] = _layout_ok(run, dec.in_placements[1], mesh) and all(
            run[i][k].to_local().data_ptr() == local[i][k] for i in range(len(run))
            for k in run[i])
    return out


def _layout_ok(cache, places, mesh) -> bool:
    """Every leaf a DTensor in ``places`` whose local shape is its global
    shape with each split dim divided by the mesh dims that split it."""
    from torch.distributed.tensor import Shard

    for slot, pslot in zip(cache, places):
        for k, x in slot.items():
            if tuple(x.placements) != tuple(pslot[k]):
                return False
            want = list(x.shape)
            for i, p in enumerate(pslot[k]):
                if isinstance(p, Shard):
                    want[p.dim] //= mesh.size(i)
            if list(x.to_local().shape) != want:
                return False
    return True


def _rank_main(rank: int, world: int, store: str, out: str, inputs_file: str) -> None:
    from repro_torch.launch.mesh import make_test_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    inputs = pickle.load(open(inputs_file, "rb"))
    try:
        got = {}
        for d, m in SHAPES:
            mesh = make_test_mesh(d, m, device_type="cpu")
            for name in CONFIGS:
                np_params, toks, padded = inputs[name]
                for dtype in DTYPES:
                    got[((d, m), name, dtype)] = _rank_serve(name, mesh, np_params, toks,
                                                             padded[dtype], dtype)
        for name in TRAIN_CONFIGS:
            got[("train", name)] = _train(_train_argv(name) + ["--data", "1", "--model", "4"])
        # plain c10d collectives under the counter: one all-reduce of 4 and one
        # all-gather of 4 float32 from every rank, each counted once
        from repro_torch.distributed import sharding

        t, whole = torch.ones(4), torch.empty(4 * world)
        sharding.COMM.reset()
        with sharding.count_collectives():
            dist.all_reduce(t)
            dist.all_gather_into_tensor(whole, t)
        got["c10d"] = (sharding.COMM.calls, dict(sharding.COMM.by_op), t.tolist())
        with open(f"{out}/rank{rank}.pkl", "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{name: {"jax": (prefill logits, [decode logits]), dtype: meshless
    port}} and the file of the ranks' inputs."""
    from repro.configs.base import get_config as jget
    from repro.models import transformer as jt

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks: the CPU's GEMMs round alike
    ref, inputs = {}, {}
    try:
        for name in CONFIGS:
            jcfg = jget(name).reduced()
            np_params = jax.tree.map(np.asarray, jt.init(jcfg, jax.random.PRNGKey(0)))
            _zero_routers(np_params)
            toks = np.random.default_rng(1).integers(
                0, jcfg.vocab_size, (B, S + STEPS)).astype(np.int32)
            jl, jc = jt.prefill(jcfg, np_params, jnp.asarray(toks[:, :S]))
            jc = jt.pad_cache(jcfg, jc, CAP)
            jdec = []
            for i in range(STEPS):
                lg, jc = jt.decode_step(jcfg, np_params, jc, jnp.asarray(toks[:, S + i:S + i + 1]),
                                        jnp.full((B,), S + i, jnp.int32))
                jdec.append(np.asarray(lg, np.float32))
            ref[name] = {"jax": (np.asarray(jl, np.float32), jdec)}
            padded = {}
            for dtype in DTYPES:
                logits, cache, pad, dec, run = _meshless(name, np_params, toks, dtype)
                ref[name][dtype] = (logits.float().numpy(),
                                    [{k: v.float().numpy() for k, v in s.items()} for s in cache],
                                    [d.float().numpy() for d in dec],
                                    [{k: v.float().numpy() for k, v in s.items()} for s in run])
                padded[dtype] = pad
            inputs[name] = (np_params, toks, padded)
        for name in TRAIN_CONFIGS:
            ref[("train", name)] = _losses(_train(_train_argv(name)))
    finally:
        torch.set_num_threads(threads)
    path = tmp_path_factory.mktemp("serve_inputs") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    return ref, str(path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, reference):
    """[per-rank outputs] of the spawned world, held to the deadline (its
    ranks killed past it or when one fails)."""
    tmp = tmp_path_factory.mktemp("serve_world")
    ctx = mp.start_processes(_rank_main, args=(WORLD, str(tmp / "store"), str(tmp),
                                               reference[1]),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_DEADLINE_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise AssertionError(f"the world of {WORLD} ranks passed its "
                                     f"{JOIN_DEADLINE_S} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(WORLD)]


def _gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _tree_gap(a, b) -> float:
    """Largest gap over the leaves, each relative to max(1, its largest
    |value|)."""
    return max(_gap(x[k], y[k]) / max(1.0, float(np.abs(y[k]).max()))
               for x, y in zip(a, b) for k in y)


SHAPE_IDS = [f"{d}x{m}" for d, m in SHAPES]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_prefill_logits_match_reference(ranks, reference, shape, name):
    ref = reference[0][name]
    for r in ranks:
        bf, f32 = r[(shape, name, "bf16")], r[(shape, name, "f32")]
        assert bf["prefill"].shape == ref["jax"][0].shape
        assert _gap(bf["prefill"], ref["jax"][0]) <= LOGIT_TOL
        assert _gap(f32["prefill"], ref["f32"][0]) <= MESH_TOL


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_decode_logits_match_reference(ranks, reference, shape, name):
    ref = reference[0][name]
    for r in ranks:
        bf, f32 = r[(shape, name, "bf16")], r[(shape, name, "f32")]
        assert len(bf["decode"]) == STEPS
        gaps_jax = [_gap(a, b) for a, b in zip(bf["decode"], ref["jax"][1])]
        gaps_port = [_gap(a, b) for a, b in zip(f32["decode"], ref["f32"][2])]
        assert max(gaps_jax) <= LOGIT_TOL, gaps_jax
        assert max(gaps_port) <= MESH_TOL, gaps_port


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_prefill_cache_is_held_as_cache_spec(ranks, reference, shape, name):
    for r in ranks:
        got = r[(shape, name, "f32")]
        assert got["prefill_layout"]
        assert r[(shape, name, "bf16")]["prefill_layout"]
        assert _tree_gap(got["prefill_cache"], reference[0][name]["f32"][1]) <= MESH_TOL


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_decode_updates_its_shards_in_place(ranks, reference, shape, name):
    for r in ranks:
        got = r[(shape, name, "f32")]
        assert got["decode_layout"]
        assert _tree_gap(got["decode_cache"], reference[0][name]["f32"][3]) <= MESH_TOL


@pytest.mark.parametrize("name", TRAIN_CONFIGS)
def test_heads_that_do_not_divide_the_model_axis_train(ranks, reference, name):
    got = _losses(ranks[0][("train", name)])
    want = reference[0][("train", name)]
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    gaps = {s: abs(got[s] - want[s]) for s in got}
    assert max(gaps.values()) <= LOSS_TOL, gaps
    assert all(not _losses(r[("train", name)]) for r in ranks[1:])  # only the lead logs


@pytest.mark.parametrize("name", ["llama3.2-1b", "mamba2-780m"])
def test_one_rank_mesh_gives_the_meshless_bits(reference, name):
    """A 1x1 mesh in a world of one: its size-1 axes split nothing, though
    ``input_sharding`` / ``cache_spec`` name them and ``constrain`` does
    not; every logit is the meshless port's, bit for bit."""
    from repro_torch.launch.mesh import init_world, make_test_mesh

    np_params, toks, padded = pickle.load(open(reference[1], "rb"))[name]
    init_world("cpu")
    try:
        got = _rank_serve(name, make_test_mesh(1, 1, device_type="cpu"), np_params, toks,
                          padded["bf16"], "bf16")
    finally:
        dist.destroy_process_group()
    ref = reference[0][name]["bf16"]
    assert got["prefill_layout"] and got["decode_layout"]
    assert np.array_equal(got["prefill"], ref[0])
    assert all(np.array_equal(a, b) for a, b in zip(got["decode"], ref[2]))


def test_count_collectives_counts_plain_c10d_calls(ranks):
    """``dist.all_reduce`` and ``dist.all_gather_into_tensor`` (the ``c10d``
    ops ``core/distributed.py`` and a hand-laid layout run, not DTensor's
    functional ones) each count once, with their output's bytes."""
    for r in ranks:
        calls, by_op, summed = r["c10d"]
        assert summed == [float(WORLD)] * 4
        assert calls == 2 and by_op == {"allreduce_": [1, 16],
                                        "_allgather_base_": [1, 16 * WORLD]}, by_op
