"""Serving engine: continuous batching over prefill/decode steps (the
port's ``src/repro/serve/engine.py``).

A fixed-slot decode batch: each of ``slots`` slots holds one in-flight
sequence.  New requests prefill one at a time and their cache rows are
spliced into a free slot; finished sequences free their slot at once.  The
decode step always runs the full ``slots x 1`` batch, each slot at its own
position; dead slots write throwaway rows into their own cache lines.
Plain eager PyTorch under ``torch.inference_mode()``; on the card the
prefill runs the flash_attention / ssd_scan kernels.  Requests carry
tokens only, as in the JAX package, so the engine serves every family but
the enc-dec (frames) and VLM (vision inputs) ones, which run through
``serve.steps`` directly.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.serve.steps import greedy_sample, make_decode_step, make_prefill_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int = 32
    out: Optional[List[int]] = None
    done: bool = False
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class Engine:
    """``params`` live on the device the engine serves on (the embedding's
    device); ``impl`` picks kernels or plain attention / SSD for prefill."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4, max_len: int = 512,
                 impl: str = "kernel"):
        if cfg.is_encdec or cfg.vision_tokens:
            raise ValueError(
                f"{cfg.name}: Engine requests carry tokens only; the {cfg.family} "
                "family needs frames or vision inputs: drive serve.steps' "
                "make_prefill_step / make_decode_step directly")
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.prefill = make_prefill_step(cfg, impl=impl)
        self.decode = make_decode_step(cfg)
        self.cache = transformer.init_cache(cfg, slots, max_len, device=self.device)
        self.live = np.zeros(slots, bool)
        self.pos = np.zeros(slots, np.int64)
        self.req: List[Optional[Request]] = [None] * slots
        self.last_tok = np.zeros((slots, 1), np.int32)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        # host-clock counters; each prefill and decode step ends in a sync
        self.prefills = self.decode_steps = self.decode_tokens = 0
        self.prefill_s = self.decode_s = 0.0

    # ------------------------------------------------------------- admission
    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        req.out = []
        self.queue.append(req)

    @torch.inference_mode()
    def _admit(self) -> None:
        while self.queue and not self.live.all():
            slot = int(np.flatnonzero(~self.live)[0])
            req = self.queue.pop(0)
            t0 = time.perf_counter()
            tokens = torch.as_tensor(np.asarray(req.prompt, np.int64)[None, :],
                                     device=self.device)
            logits, cache1 = self.prefill(self.params, {"tokens": tokens})
            cache1 = transformer.pad_cache(self.cfg, cache1, self.max_len)
            # splice the prefilled rows into the batched cache at `slot`
            for big_s, one_s in zip(self.cache, cache1):
                for name, big in big_s.items():
                    one = one_s[name]
                    big[:, slot, :one.shape[2]] = one[:, 0].to(big.dtype)
            tok = int(greedy_sample(logits)[0, 0])
            req.out.append(tok)
            req.t_first = time.perf_counter()
            self.prefills += 1
            self.prefill_s += req.t_first - t0
            self.live[slot] = True
            self.pos[slot] = len(req.prompt)
            self.req[slot] = req
            self.last_tok[slot, 0] = tok

    # ----------------------------------------------------------------- step
    @torch.inference_mode()
    def step(self) -> int:
        """One engine iteration; returns the number of live sequences."""
        self._admit()
        if not self.live.any():
            return 0
        t0 = time.perf_counter()
        logits, self.cache = self.decode(self.params, self.cache, {
            "token": torch.as_tensor(self.last_tok, device=self.device).to(torch.int64),
            "pos": torch.as_tensor(self.pos, device=self.device),
        })
        toks = greedy_sample(logits).cpu().numpy()
        now = time.perf_counter()
        self.decode_steps += 1
        self.decode_tokens += int(self.live.sum())
        self.decode_s += now - t0
        for slot in np.flatnonzero(self.live):
            req = self.req[slot]
            tok = int(toks[slot, 0])
            req.out.append(tok)
            self.last_tok[slot, 0] = tok
            self.pos[slot] += 1
            if len(req.out) >= req.max_new or self.pos[slot] >= self.max_len - 1:
                req.done = True
                req.t_done = now
                self.finished.append(req)
                self.live[slot] = False
                self.req[slot] = None
        return int(self.live.sum())

    def run(self) -> List[Request]:
        while self.queue or self.live.any():
            self.step()
        return self.finished
