"""LM serving CLI: a burst of requests through the continuous-batching
engine (the port's counterpart of ``examples/serve_demo.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --config llama3.2-1b
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced \
        --config mixtral-8x7b

Weights are random, drawn from ``--seed`` on the device (no weights ship
with the repo).  The burst is ``--requests`` prompts with lengths drawn
from {128, 256, 512, 1024} tokens (each length once per four requests) and 16-32 new tokens each, also from
``--seed``; those lengths are ones the attention kernel (any S), the
plain attention (S <= 1024 or a multiple of 1024) and the SSD scan (S <=
128 or a multiple of 128) all accept.  On the
card every prefill runs the flash_attention kernel once per attention
layer and the ssd_scan kernel once per Mamba layer.  ``--config`` offers
every model ``Engine`` serves: all but the enc-dec and VLM ones, whose
requests need frames or vision inputs.  Prints the requests served,
tokens, time to first token (TTFT) and decode tokens/s, naming the device.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config, list_configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve.engine import Engine, Request

PROMPT_LENGTHS = (128, 256, 512, 1024)
MAX_NEW = (16, 32)


def build_params(cfg: ModelConfig, seed: int, device) -> dict:
    """Serving parameters: float32 masters drawn from ``seed`` on the
    device, with the weights the model casts to bf16 cast once, leaf by
    leaf (``transformer.init_compute_params``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return transformer.init_compute_params(cfg, gen, device=dev)


def served_configs() -> List[str]:
    """The configs ``Engine`` serves (requests of tokens alone)."""
    return [n for n in list_configs()
            if not (get_config(n).is_encdec or get_config(n).vision_tokens)]


def make_burst(cfg: ModelConfig, n: int, seed: int) -> List[Request]:
    """``n`` requests; the prompt lengths are a shuffle of the four lengths
    repeated, so a burst of 4 or more has every length."""
    rng = np.random.default_rng(seed)
    reps = -(-n // len(PROMPT_LENGTHS))
    lengths = rng.permutation(np.repeat(PROMPT_LENGTHS, reps))[:n]
    out = []
    for rid, plen in enumerate(lengths):
        plen = int(plen)
        prompt = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        out.append(Request(rid=rid, prompt=prompt,
                           max_new=int(rng.integers(MAX_NEW[0], MAX_NEW[1] + 1))))
    return out


def serve_burst(cfg: ModelConfig, params: dict, requests: Sequence[Request], *,
                slots: int = 4, max_len: int = 2048, impl: str = "kernel"
                ) -> Tuple[List[Request], dict]:
    """Serve ``requests`` (all submitted at once); returns the finished
    requests and the run's numbers: wall seconds, prefills, decode steps,
    tokens, TTFT (seconds from submit to the first token) and decode
    tokens/s.  Host clock; each step ends in a device sync."""
    eng = Engine(cfg, params, slots=slots, max_len=max_len, impl=impl)
    dev = eng.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for r in requests:
        eng.submit(r)
    eng.run()
    wall = time.perf_counter() - t0
    done = sorted(eng.finished, key=lambda r: r.rid)
    ttft = np.array([r.t_first - r.t_submit for r in done])
    stats = dict(
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        requests=len(done), prefills=eng.prefills, decode_steps=eng.decode_steps,
        tokens=sum(len(r.out) for r in done), decode_tokens=eng.decode_tokens,
        wall_s=wall, prefill_s=eng.prefill_s, decode_s=eng.decode_s,
        decode_tokens_per_s=eng.decode_tokens / eng.decode_s if eng.decode_s > 0 else None,
        tokens_per_s=sum(len(r.out) for r in done) / wall,
        ttft_mean_s=float(ttft.mean()), ttft_p50_s=float(np.median(ttft)),
        ttft_max_s=float(ttft.max()))
    return done, stats


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="llama3.2-1b", choices=served_configs())
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's tiny same-family reduction (CPU smoke)")
    args = ap.parse_args(argv)

    cfg = get_config(args.config)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = build_params(cfg, args.seed, dev)
    requests = make_burst(cfg, args.requests, args.seed)
    if max(len(r.prompt) for r in requests) + MAX_NEW[1] >= args.max_len:
        ap.error(f"--max-len {args.max_len} leaves no room for a "
                 f"{max(PROMPT_LENGTHS)}-token prompt and {MAX_NEW[1]} new tokens")
    done, st = serve_burst(cfg, params, requests, slots=args.slots,
                           max_len=args.max_len)
    print(f"[serve] {cfg.name} on {st['device']}: served {st['requests']} requests, "
          f"{st['tokens']} tokens in {st['wall_s']:.3f}s ({st['prefills']} prefills, "
          f"{st['decode_steps']} decode steps of {args.slots} slots)")
    dtps = st["decode_tokens_per_s"]
    print(f"[serve] TTFT mean {st['ttft_mean_s'] * 1e3:.1f} ms, median "
          f"{st['ttft_p50_s'] * 1e3:.1f} ms, max {st['ttft_max_s'] * 1e3:.1f} ms; "
          f"decode {'n/a' if dtps is None else f'{dtps:.1f}'} tokens/s; "
          f"{st['tokens_per_s']:.1f} tokens/s overall")
    for r in done[:4]:
        print(f"  req {r.rid}: prompt {len(r.prompt):4d} -> {len(r.out):3d} new "
              f"(TTFT {(r.t_first - r.t_submit) * 1e3:.1f} ms) {r.out[:8]}...")
    return 0


if __name__ == "__main__":
    sys.exit(main())
