"""The port's synthetic data pipeline against the JAX package's, on the CPU.

Batches must equal the JAX package's bit for bit (values and dtypes), the
modality extras included: the generator is the same numpy code fed the
same ``(seed, step)``.  No tolerance.
"""
from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jdata
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.data import pipeline as tdata
from repro_torch.launch.cells import input_specs


def _extras(cfg, batch, seq):
    return {k: v for k, v in input_specs(cfg, ShapeSpec("t", seq, batch, "train")).items()
            if k not in ("inputs", "targets")}


@pytest.mark.parametrize("name,vocab", [("llama3.2-1b", 1000), ("qwen2-vl-2b", 5000),
                                        ("whisper-medium", 300), ("mamba2-780m", 50280)])
def test_batches_equal_reference(name, vocab):
    cfg = get_config(name).reduced()
    B, S = 3, 24
    extras = _extras(cfg, B, S)
    jextras = {k: jax.ShapeDtypeStruct(shape, jnp.float32 if dt.is_floating_point else jnp.int32)
               for k, (shape, dt) in extras.items()}
    got_fn = tdata.make_batch_fn(vocab, S, B, seed=11, extras=extras)
    want_fn = jdata.make_batch_fn(vocab, S, B, seed=11, extras=jextras)
    for step in (0, 1, 17):
        got, want = got_fn(step), want_fn(step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k])


def test_host_slice_equals_reference():
    src, ref = tdata.SyntheticLM(700, 16, 6, seed=2), jdata.SyntheticLM(700, 16, 6, seed=2)
    for sl in (None, (0, 3), (2, 6)):
        got, want = src.batch_at(5, host_slice=sl), ref.batch_at(5, host_slice=sl)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_determinism_and_shift():
    src = tdata.make_batch_fn(1000, 64, 4, seed=3)
    b1, b2 = src(7), src(7)
    np.testing.assert_array_equal(b1["inputs"], b2["inputs"])
    assert not np.array_equal(src(7)["inputs"], src(8)["inputs"])
    np.testing.assert_array_equal(b1["inputs"][:, 1:], b1["targets"][:, :-1])


def test_data_state_round_trip():
    st = tdata.DataState(seed=5, step=123)
    assert tdata.DataState.from_tree(st.as_tree()) == st
    assert tdata.DataState.from_tree(jdata.DataState(5, 123).as_tree()) == st


def test_prefetch_iter_keeps_order_and_stops_its_thread():
    before = threading.active_count()
    it = tdata.prefetch_iter(lambda s: {"x": np.asarray([s])}, start_step=5)
    got = [next(it) for _ in range(6)]
    assert [s for s, _ in got] == [5, 6, 7, 8, 9, 10]
    assert [int(b["x"][0]) for _, b in got] == [5, 6, 7, 8, 9, 10]
    it.close()
    assert threading.active_count() == before


def test_prefetch_iter_raises_a_fault_of_the_batch_fn():
    def batch_fn(s):
        if s == 3:
            raise KeyError("no batch 3")
        return s

    it = tdata.prefetch_iter(batch_fn, start_step=1)
    assert [next(it)[0], next(it)[0]] == [1, 2]
    with pytest.raises(KeyError, match="no batch 3"):
        next(it)


def test_to_device_on_the_cpu():
    b = tdata.make_batch_fn(300, 8, 2, seed=1,
                            extras={"frames": ((2, 8, 16), torch.bfloat16)})(0)
    t = tdata.to_device(b, torch.device("cpu"))
    assert t["inputs"].dtype == t["targets"].dtype == torch.int64
    assert t["frames"].dtype == torch.float32
    np.testing.assert_array_equal(t["inputs"].numpy(), b["inputs"])
    np.testing.assert_array_equal(t["frames"].numpy(), b["frames"])
