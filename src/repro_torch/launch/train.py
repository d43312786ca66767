"""Training launcher (the port's ``src/repro/launch/train.py``).

    python -m repro_torch.launch.train --arch llama3.2-1b --steps 300 \\
        --d-model 256 --layers 4 --seq 256 --batch 8      # on the card
    python -m repro_torch.launch.train --device cpu --d-model 64 --layers 2 \\
        --seq 32 --batch 2 --steps 6                      # plain PyTorch, CPU

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
* ``--data`` / ``--model`` (the LM on a device mesh) raise: ROADMAP.md,
  queue A, "Multi-device: the LM on a mesh".
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import get_config
from repro_torch.core.engine import NOT_PORTED
from repro_torch.data.pipeline import make_batch_fn, pinned, prefetch_iter, to_device
from repro_torch.device import resolve_device
from repro_torch.launch.cells import input_specs
from repro_torch.models import transformer
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adamw_init
from repro_torch.train.step import make_train_step


def build_state(cfg, device, seed: int):
    """(params, AdamW state) on ``device``: float32 masters from a generator
    seeded with ``seed``, each leaf requiring grad."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = transformer.init(cfg, gen, device=device)
    for p in tree_leaves(params):
        p.requires_grad_()
    return params, adamw_init(params)


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
    ap.add_argument("--data", type=int, default=1, help="mesh data-axis size")
    ap.add_argument("--model", type=int, default=1, help="mesh model-axis size")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.data > 1 or args.model > 1:
        raise ValueError(f"--data {args.data} --model {args.model}: a device mesh is "
                         f"{NOT_PORTED}")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.d_model or args.layers:
        cfg = cfg.reduced(
            **({"d_model": args.d_model} if args.d_model else {}),
            **({"n_layers": args.layers} if args.layers else {}),
        )

    params, opt = build_state(cfg, dev, args.seed)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params on {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))

    step_fn = make_train_step(cfg, peak_lr=args.lr, total_steps=args.steps,
                              accum=args.accum, warmup_steps=max(args.steps // 20, 5))
    extras = {k: v for k, v in input_specs(cfg, "train", args.batch, args.seq).items()
              if k not in ("inputs", "targets")}
    batch_fn = make_batch_fn(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                             extras=extras)
    host_batch = (lambda s: pinned(batch_fn(s))) if dev.type == "cuda" else batch_fn

    start = 0
    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt_dir and store.latest_step(ckpt_dir) is not None:
        (params, opt), start = store.restore_tree(ckpt_dir, (params, opt))
        print(f"[train] auto-resumed from step {start}")

    t0 = time.time()
    losses = []
    it = prefetch_iter(host_batch, start)
    try:
        for step_idx, batch in it:
            if step_idx >= args.steps:
                break
            params, opt, metrics = step_fn(params, opt, to_device(batch, dev))
            if step_idx % args.log_every == 0 or step_idx == args.steps - 1:
                loss = float(metrics["loss"])  # waits for the step
                losses.append(loss)
                print(f"[train] step {step_idx:5d} loss {loss:.6f} "
                      f"gnorm {float(metrics['grad_norm']):.4f} "
                      f"lr {float(metrics['lr']):.4e} ({time.time() - t0:.3f}s)", flush=True)
            done = step_idx + 1
            if ckpt_dir and done % args.ckpt_every == 0 and done < args.steps:
                store.save_tree(ckpt_dir, done, (params, opt))
                print(f"[train] checkpoint @ {done}", flush=True)
    finally:
        it.close()
    if ckpt_dir:
        store.save_tree(ckpt_dir, args.steps, (params, opt))
    if len(losses) >= 2:
        print(f"[train] loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"({'DOWN' if losses[-1] < losses[0] else 'FLAT'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
