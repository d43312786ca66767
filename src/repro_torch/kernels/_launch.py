"""What the kernels' wrappers share: the ``repro_torch`` operators they
call.

Every kernel is an operator ``repro_torch::<name>`` with a schema and a
fake implementation (``define``), both defined here in Python when its
``ops.py`` is imported: under ``FakeTensorMode`` (the dry-run, PyTorch's
tracing tools) the fake one computes the outputs' shapes, dtypes and
device from the inputs alone and raises the wrapper's shape errors.  Its
CUDA implementation is C++ (``csrc/<name>_op.cpp``), registered when
``kernels/_build.load`` opens its library at the wrapper's first call on
real CUDA tensors.  No operator has a CPU implementation: a CPU tensor
that reaches one raises (the wrappers run their plain versions on CPU
tensors before any operator)."""
from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch

NAMESPACE = "repro_torch"
_FRAGMENTS = []  # the registrations live as long as their Library objects


def define(schema: str, fake: Callable) -> torch._ops.OpOverload:
    """Define ``repro_torch::<schema>`` with its fake implementation and
    return the operator (its default overload).  Nothing it writes was
    allocated by its caller: each schema is functional."""
    lib = torch.library.Library(NAMESPACE, "FRAGMENT")
    lib.define(schema)
    name = schema.split("(", 1)[0]

    def on_cuda(first, *rest):  # as the CUDA-only operator dispatches
        if first.device.type != "cuda":
            raise NotImplementedError(f"{NAMESPACE}::{name} has a CUDA implementation "
                                      f"only, got a tensor on {first.device}")
        return fake(first, *rest)

    torch.library.register_fake(f"{NAMESPACE}::{name}", on_cuda, lib=lib)
    _FRAGMENTS.append(lib)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def is_real(t: torch.Tensor) -> bool:
    """Whether ``t`` is a plain tensor, so that an operator called on it
    runs its kernel: a fake (or traced) one launches nothing."""
    return type(t) is torch.Tensor


def float32_values(values: Iterable[float]) -> Tuple[float, ...]:
    """Each value rounded to float32, as the launchers read their
    constants (an operator's ``float[]`` argument: the C cast of each of
    these doubles is exact)."""
    return tuple(float(v) for v in np.asarray([float(v) for v in values], np.float32))
