"""Faults planted in the program under test, to show that the check catches
them (``bench/tests/test_bench_faults.py``, ``bench.harness.readings``).

Each is a context manager that patches the program while it is open:

* ``frozen_step``: every GA generation returns its population unchanged;
* ``half_frozen``: in each launch of two searches or more, the second
  half's GA generations return their populations unchanged (the searches
  are left out, and answer with their seeded populations);
* ``half_joint_frozen``: the same, in the sweep's joint launch alone
  (``joint_search_batched``), so that a tenth of the sweep's searches do
  not search;
* ``half_joint_copied``: the second half of the joint launch's searches is
  left out, and their requests get the first half's answers;
* ``half_batch``: the second half of each launch's searches is left out,
  and its requests get answers of the first half;
* ``altered_answer``: the first answer of each launch has its best score
  altered by one part in a thousand where it is produced (and so its
  best-so-far's end).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def _finalizers(edit):
    """Wrap the engine's finalizers (both result paths) with ``edit``."""
    from repro_torch.core import engine

    def wrap(fn):
        def finalize(*args, **kw):
            return edit(fn(*args, **kw))
        return finalize

    with _patched(engine, "_finalize_batch", wrap(engine._finalize_batch)), \
            _patched(engine, "_finalize_batch_thin", wrap(engine._finalize_batch_thin)):
        yield


def frozen_step():
    from repro_torch.core import ga

    def make_gen_step(*args, **kw):
        return lambda pop, scores, u: (pop, scores, pop, scores)

    return _patched(ga, "make_gen_step", make_gen_step)


@contextlib.contextmanager
def _half_frozen(joint_only: bool):
    from repro_torch.core import ga, search

    inside = [not joint_only]
    make = ga.make_gen_step
    joint = search.joint_search_batched

    def make_gen_step(*args, **kw):
        step = make(*args, **kw)
        if not inside[0]:
            return step

        def gen(pop, scores, u):
            new_pop, new_scores, children, child_scores = step(pop, scores, u)
            B = pop.shape[0]
            if B < 2:
                return new_pop, new_scores, children, child_scores
            k = B - B // 2  # rows k and on are left unevolved

            def keep(new, old):
                return torch.cat([new[:k], old[k:]])

            return (keep(new_pop, pop), keep(new_scores, scores), keep(children, pop),
                    keep(child_scores, scores))
        return gen

    def joint_search_batched(*args, **kw):
        inside[0] = True
        try:
            return joint(*args, **kw)
        finally:
            inside[0] = not joint_only

    with _patched(ga, "make_gen_step", make_gen_step), \
            _patched(search, "joint_search_batched", joint_search_batched):
        yield


def half_frozen():
    return _half_frozen(joint_only=False)


def half_joint_frozen():
    return _half_frozen(joint_only=True)


@contextlib.contextmanager
def half_joint_copied():
    from repro_torch.core import search

    joint = search.joint_search_batched

    def joint_search_batched(*args, **kw):
        results = joint(*args, **kw)
        h = len(results) // 2
        return results[:len(results) - h] + results[:h]

    with _patched(search, "joint_search_batched", joint_search_batched):
        yield


def half_batch():
    def edit(results):
        h = len(results) // 2
        return results[:len(results) - h] + results[:h]

    return _finalizers(edit)


def altered_answer():
    def edit(results):
        if results and len(results[0].top_scores):
            s = np.array(results[0].top_scores, copy=True)
            s[0] = s[0] * np.float32(1.001)
            results[0].top_scores = s
            conv = np.array(results[0].convergence, copy=True)
            conv[-1] = s[0]
            results[0].convergence = conv
        return results

    return _finalizers(edit)


FAULTS = {"frozen_step": frozen_step, "half_frozen": half_frozen,
          "half_joint_frozen": half_joint_frozen, "half_joint_copied": half_joint_copied,
          "half_batch": half_batch, "altered_answer": altered_answer}
