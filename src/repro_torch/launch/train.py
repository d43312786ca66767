"""Training launcher (the port's ``src/repro/launch/train.py``).

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 300 \\
        --d-model 256 --layers 4 --seq 256 --batch 8      # on the card
    python -m repro_torch.launch.train --device cpu --d-model 64 --layers 2 \\
        --seq 32 --batch 2 --steps 6                      # plain PyTorch, CPU
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
        --data 2 --d-model 64 --layers 2 --seq 32 --batch 4 --steps 6  # a mesh

* The parameters are float32 masters drawn from ``--seed`` on the device
  (``transformer.init``); the step (``train.step.make_train_step``) takes
  the plain attention and SSD with remat, clipping, the cosine schedule
  and AdamW.
* Batches come from the synthetic pipeline (``data/pipeline.py``), prepared
  on a background thread in page-locked memory and copied to the card
  without blocking the host.
* With ``--ckpt-dir``, a checkpoint of (params, AdamW state) every
  ``--ckpt-every`` steps and at the end, atomic; the same command restarted
  resumes from the newest committed step, replaying the data stream from
  there (batch ``i`` is a pure function of ``(seed, i)``).  A checkpoint's
  step is the number of steps taken, as the JAX launcher's final one is;
  the JAX launcher labels the others with the index of the step just
  taken, so its resume takes that step's batch twice.
* ``--data`` / ``--model`` train on a ``(data, model)`` mesh of ranks
  (``launch.mesh.make_test_mesh``, clamped to the world: a world of one runs
  1x1), one process per card under torchrun (``launch.mesh.init_world``;
  NCCL on the card, gloo on the CPU).  The masters and both AdamW moments
  are DTensors placed by the JAX package's rules
  (``distributed.sharding.params_sharding``: FSDP over ``data``, tensor and
  expert parallelism over ``model``); each rank draws the whole of each
  leaf from the seed, keeps its shard and drops the rest, so the values are
  the meshless run's.  Each rank takes its ``input_sharding`` slice of the
  same global batch, and the step runs under ``ctx.use_rules``.  Auto-resume
  goes through ``store.restore_resharded``: a checkpoint restores onto any
  mesh shape.  The mesh's first rank prints the log; every rank prints its
  local state bytes and, with ``--count-comm``, the last step's collective
  calls and bytes (``sharding.COMM``).
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint import store
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.data.pipeline import make_batch_fn, pinned, prefetch_iter, to_device
from repro_torch.device import resolve_device
from repro_torch.distributed import ctx as dist_ctx
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as lmesh
from repro_torch.launch.cells import input_specs
from repro_torch.models import transformer
from repro_torch.models.common import init_params, tree_leaves
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.train.step import make_train_step


def build_state(cfg, device, seed: int, mesh=None):
    """(params, AdamW state) on ``device``: float32 masters from a generator
    seeded with ``seed``, each leaf requiring grad.  With ``mesh``, each
    leaf is a DTensor placed by ``params_sharding``: drawn whole, one leaf
    at a time, and cut to this rank's shard at once."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if mesh is None:
        params = transformer.init(cfg, gen, device=device)
    else:
        tmpl = transformer.param_template(cfg)
        places = iter(sharding.placement_leaves(
            sharding.params_sharding(cfg, mesh, tmpl)))
        params = init_params(tmpl, gen, torch.float32, device,
                             cast=lambda _, leaf: dist_ctx.distribute(leaf, mesh, next(places)))
    for p in tree_leaves(params):
        p.requires_grad_()
    return params, adamw_init(params)


def state_sharding(cfg, mesh):
    """The placements tree of ``build_state``'s (params, AdamW state): the
    moments take their parameter's, the step count stays a plain tensor."""
    shard = sharding.params_sharding(cfg, mesh, transformer.param_template(cfg))
    return shard, AdamWState(step=None, mu=shard, nu=shard)


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's leaves (a DTensor's local shard)."""
    total = 0
    for x in tree_leaves(tree):
        x = x.to_local() if hasattr(x, "to_local") else x
        total += x.numel() * x.element_size()
    return total


def batch_source(cfg, seq: int, batch: int, seed: int, dev: torch.device, mesh=None):
    """(batch_fn, placed): ``batch_fn(step)`` the host arrays of step
    ``step``'s batch (the synthetic pipeline's, a pure function of ``(seed,
    step)``; on a mesh this rank's ``input_sharding`` slice of it), and
    ``placed(arrays)`` them on ``dev`` (DTensors on a mesh)."""
    shape = ShapeSpec("train", seq, batch, "train")
    extras = {k: v for k, v in input_specs(cfg, shape).items()
              if k not in ("inputs", "targets")}
    batch_fn = make_batch_fn(cfg.vocab_size, seq, batch, seed=seed, extras=extras)
    if mesh is not None:
        specs = sharding.input_sharding(cfg, shape, mesh)
        places = {k: dist_ctx.placements(mesh, v) for k, v in specs.items()}
        whole = batch_fn

        def batch_fn(step):  # this rank's slice of the global batch
            return {k: dist_ctx.local_shard(torch.as_tensor(v), mesh, places[k]).contiguous()
                    for k, v in whole(step).items()}

    def placed(arrays):
        arrays = to_device(arrays, dev)
        if mesh is None:
            return arrays
        return {k: DTensor.from_local(v, mesh, places[k], run_check=False)
                for k, v in arrays.items()}

    return batch_fn, placed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=0, help="reduce: override width")
    ap.add_argument("--layers", type=int, default=0, help="reduce: override depth")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", type=int, default=None,
                    help="mesh data-axis size (train on a mesh)")
    ap.add_argument("--model", type=int, default=None,
                    help="mesh model-axis size (train on a mesh)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--count-comm", action="store_true",
                    help="on a mesh, count the last step's collectives (a dispatch mode "
                         "that slows that step) and print them on its line")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.data is None and args.model is None:
        return _train(args, resolve_device(args.device), None)
    own_world = not dist.is_initialized()
    _, _, dev = lmesh.init_world(args.device)
    try:
        mesh = lmesh.make_test_mesh(args.data or 1, args.model or 1, device_type=dev.type)
        return 0 if mesh is None else _train(args, dev, mesh)  # None: left out
    finally:
        if own_world:  # a world of one this call made
            dist.destroy_process_group()


def _train(args, dev: torch.device, mesh) -> int:
    lead = mesh is None or not any(mesh.get_coordinate())
    say = print if lead else (lambda *a, **k: None)
    cfg = get_config(args.arch)
    if args.d_model or args.layers:
        cfg = cfg.reduced(
            **({"d_model": args.d_model} if args.d_model else {}),
            **({"n_layers": args.layers} if args.layers else {}),
        )

    params, opt = build_state(cfg, dev, args.seed, mesh)
    n_params = sum(p.numel() for p in tree_leaves(params))
    where = f"{dev}" + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")
    if mesh is not None:
        where = (f"mesh {lmesh.describe(mesh)} ({dist.get_world_size()} ranks, "
                 f"{dist.get_backend()}) of {where}")
    say(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params on {where}")
    if mesh is not None:  # every rank
        print(f"[train] rank {dist.get_rank()} local state bytes "
              f"{local_bytes((params, opt))}", flush=True)

    step_fn = make_train_step(cfg, peak_lr=args.lr, total_steps=args.steps,
                              accum=args.accum, warmup_steps=max(args.steps // 20, 5))
    batch_fn, placed = batch_source(cfg, args.seq, args.batch, args.seed, dev, mesh)
    host_batch = (lambda s: pinned(batch_fn(s))) if dev.type == "cuda" else batch_fn

    start = 0
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt_dir and store.latest_step(ckpt_dir) is not None:
        if mesh is None:
            (params, opt), start = store.restore_tree(ckpt_dir, (params, opt))
        else:
            (params, opt), start = store.restore_resharded(
                ckpt_dir, (params, opt), state_sharding(cfg, mesh), mesh)
        say(f"[train] auto-resumed from step {start}")

    t0 = time.time()
    losses = []
    it = prefetch_iter(host_batch, start)
    scope = (dist_ctx.use_rules(mesh, sharding.make_rules(mesh)) if mesh is not None
             else contextlib.nullcontext())
    try:
        with scope:
            for step_idx, batch in it:
                if step_idx >= args.steps:
                    break
                last = step_idx == args.steps - 1
                count = mesh is not None and args.count_comm and last
                sharding.COMM.reset()
                with sharding.count_collectives() if count else contextlib.nullcontext():
                    params, opt, metrics = step_fn(params, opt, placed(batch))
                if step_idx % args.log_every == 0 or last:
                    loss = float(metrics["loss"])  # waits for the step
                    losses.append(loss)
                    comm = (f" comm {sharding.COMM.calls} calls "
                            f"{sharding.COMM.bytes} B" if count else "")
                    say(f"[train] step {step_idx:5d} loss {loss:.6f} "
                        f"gnorm {float(metrics['grad_norm']):.6f} "
                        f"lr {float(metrics['lr']):.4e} ({time.time() - t0:.3f}s){comm}",
                        flush=True)
                    if count and not lead:  # each rank's own collectives
                        print(f"[train] rank {dist.get_rank()} step {step_idx}{comm}",
                              flush=True)
                    if count:
                        say("[train] comm by op: " + "; ".join(
                            f"{k} {c} calls {b} B" for k, (c, b) in
                            sorted(sharding.COMM.by_op.items())), flush=True)
                done = step_idx + 1
                if ckpt_dir and done % args.ckpt_every == 0 and done < args.steps:
                    store.save_tree(ckpt_dir, done, (params, opt))
                    say(f"[train] checkpoint @ {done}", flush=True)
    finally:
        it.close()
    if ckpt_dir:
        store.save_tree(ckpt_dir, args.steps, (params, opt))
    if len(losses) >= 2:
        say(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({'DOWN' if losses[-1] < losses[0] else 'FLAT'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
