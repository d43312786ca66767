"""Serving demo: continuous batching on a reduced mixtral (MoE + sliding
window), the counterpart of ``examples/serve_demo.py``.

Submits a burst of requests with different prompt and output lengths,
drawn as the JAX demo draws them; the engine prefills into free slots and
decodes all live slots per step.  Random weights from seed 0 on the
device.  On the card every prefill runs the flash_attention kernel once
per layer.

    PYTHONPATH=src python -m repro_torch.examples.serve_demo
    PYTHONPATH=src python -m repro_torch.examples.serve_demo --device cpu --requests 3
"""
import argparse
import sys
import time
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_params
from repro_torch.serve.engine import Engine, Request


def burst(cfg, n: int) -> List[Request]:
    """``n`` requests drawn from ``default_rng(0)`` as the JAX demo draws
    them: prompts of 4-23 tokens, 8-23 new tokens each."""
    rng = np.random.default_rng(0)
    out = []
    for rid in range(n):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        out.append(Request(rid=rid, prompt=prompt, max_new=int(rng.integers(8, 24))))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=10)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("mixtral-8x7b").reduced()
    params = build_params(cfg, 0, dev)
    eng = Engine(cfg, params, slots=4, max_len=128)
    for r in burst(cfg, args.requests):
        eng.submit(r)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out) for r in done)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"served {len(done)} requests, {total_new} tokens in {dt:.1f}s "
          f"({total_new / dt:.1f} tok/s on {where})")
    for r in sorted(done, key=lambda r: r.rid)[:5]:
        ttft = (r.t_first - r.t_submit) * 1e3
        print(f"  req {r.rid}: prompt {len(r.prompt):3d} -> {len(r.out):3d} new "
              f"(TTFT {ttft:.0f}ms) {r.out[:8]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
