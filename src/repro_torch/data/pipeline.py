"""Deterministic synthetic token pipeline (the port's
``src/repro/data/pipeline.py``).

* Batch ``i`` is a pure function of ``(seed, i)``: a restart from a
  checkpoint replays the token stream from its step.  The generator code is
  the JAX package's numpy, copied, so both packages give the same batches
  bit for bit, modality extras included.
* The stream is a Zipf-like unigram mix with a Markov overlay, so the loss
  falls during training.
* ``prefetch_iter`` keeps batches ahead of the step on a background
  thread; ``pinned`` and ``to_device`` move a batch to the card from
  page-locked host memory with ``non_blocking=True``.

The JAX package's host sharding (``host_slice``) serves multi-host runs;
one process reads the whole batch here.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class DataState:
    """Checkpointable pipeline position."""

    seed: int
    step: int

    def as_tree(self):
        return {"seed": np.int64(self.seed), "step": np.int64(self.step)}

    @staticmethod
    def from_tree(t) -> "DataState":
        return DataState(seed=int(t["seed"]), step=int(t["step"]))


class SyntheticLM:
    """Markov-modulated Zipf tokens: learnable but non-trivial statistics."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        # fixed "grammar": each token deterministically biases the next
        rng = np.random.default_rng(seed ^ 0xC0FFEE)
        self._succ = rng.integers(0, vocab_size, size=(min(vocab_size, 4096),), dtype=np.int64)

    def batch_at(self, step: int, *, host_slice: Optional[Tuple[int, int]] = None
                 ) -> Dict[str, np.ndarray]:
        lo, hi = host_slice or (0, self.batch)
        rng = np.random.default_rng((self.seed, step))
        # Zipf-like marginal over a capped alphabet
        alpha = 1.1
        cap = min(self.vocab, 4096)
        ranks = np.arange(1, cap + 1)
        p = ranks ** (-alpha)
        p /= p.sum()
        draws = rng.choice(cap, size=(self.batch, self.seq + 1), p=p)
        # Markov overlay: half the positions follow the grammar's successor
        follow = rng.random((self.batch, self.seq)) < 0.5
        for t in range(1, self.seq + 1):
            idx = draws[:, t - 1] % len(self._succ)
            draws[:, t] = np.where(follow[:, t - 1], self._succ[idx], draws[:, t])
        toks = draws[lo:hi].astype(np.int32)
        return {"inputs": toks[:, :-1], "targets": toks[:, 1:]}


def make_batch_fn(vocab_size: int, seq_len: int, global_batch: int, *, seed: int = 0,
                  extras: Optional[Dict[str, Tuple[Tuple[int, ...], Any]]] = None):
    """``batch_fn(step) -> dict`` of numpy arrays, with the modality extras
    (``extras``: name -> ``(shape, dtype)``, as ``launch/cells.input_specs``
    gives them) drawn from the same ``(seed, step)``: ``mrope_pos`` the token
    index on all three streams (int32), every other extra N(0, 0.02^2) in
    float32, as in the JAX package."""
    src = SyntheticLM(vocab_size, seq_len, global_batch, seed)
    extras = extras or {}

    def batch_fn(step: int) -> Dict[str, np.ndarray]:
        b = src.batch_at(step)
        rng = np.random.default_rng((seed ^ 0xFEED, step))
        for name, (shape, _dtype) in extras.items():
            if name == "mrope_pos":
                pos = np.broadcast_to(np.arange(seq_len, dtype=np.int32),
                                      (3, global_batch, seq_len))
                b[name] = np.ascontiguousarray(pos)
            else:
                b[name] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
        return b

    return batch_fn


def prefetch_iter(batch_fn, start_step: int, *, depth: int = 2) -> Iterator:
    """Yields ``(step, batch_fn(step))`` for step = start_step, start_step + 1,
    ... in order, computed on a background thread up to ``depth`` ahead.  A
    fault in ``batch_fn`` is raised here; closing the iterator (or leaving
    the loop that reads it) stops and joins the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        s = start_step
        while not stop.is_set():
            try:
                item = (s, batch_fn(s), None)
            except BaseException as e:  # handed to the reader, which raises it
                put((s, None, e))
                return
            if not put(item):
                return
            s += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            s, batch, err = q.get()
            if err is not None:
                raise err
            yield s, batch
    finally:
        stop.set()
        t.join()


def pinned(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Each array of a batch as a tensor in page-locked host memory (an
    asynchronous copy to the card can start from it)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in batch.items()}


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch on ``device``: token ids as int64, every other array as it
    is.  From pinned memory to the card the copies do not block the host."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        t = t.to(device, non_blocking=True)
        out[k] = t.long() if k in ("inputs", "targets") else t
    return out
