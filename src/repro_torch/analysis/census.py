"""What a traced step runs, counted from its dispatch stream (the port's
counterpart of ``src/repro/analysis/hlo.py``).

The JAX package parses the optimized HLO text of a compiled step for its
collective traffic and an op census.  An eager PyTorch step has no such
program; every operator it runs passes the dispatcher instead, aten's and
the port's kernels alike (``repro_torch::imc_eval`` ...: operators with
fake implementations, ``kernels/_launch.py``), where a
``TorchDispatchMode`` sees it with its tensors (real, or fake under
``FakeTensorMode``: shapes, no storage).  So:

* ``Census`` counts every operator that reaches the local tensors of a
  rank (DTensor's own calls are passed on: they lower to local ones), by
  name (``op_census``: the JAX module's census), its FLOPs by
  ``FlopCounterMode``'s formulas (``torch.utils.flop_counter``: matrix
  products, convolutions, attention; elementwise work counts none, and so
  does a kernel operator, which has no formula: B1's cost model is
  elementwise work), and the bytes each non-view operator reads and
  writes (each tensor argument read once, each result written once): the
  counterpart of XLA's "bytes accessed", which
  also counts what fusion would keep on chip, as an unfused eager step
  really moves it;
* collectives are ``distributed.sharding.count_collectives``' (DTensor's
  functional collectives and the plain ``c10d`` ones, each call once, its
  output's bytes), summarised here as ``CollectiveStats`` by op
  (``collective_stats``) and by size (``largest_collectives``).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.distributed.sharding import COLLECTIVE_NAMESPACES, CommStats


@dataclasses.dataclass
class CollectiveStats:
    total_bytes: int
    by_kind: Dict[str, int]
    counts: Dict[str, int]


def collective_stats(comm: CommStats) -> CollectiveStats:
    """Calls and output bytes by op of the collectives ``comm`` counted."""
    return CollectiveStats(total_bytes=comm.bytes,
                           by_kind={k: v[1] for k, v in comm.by_op.items()},
                           counts={k: v[0] for k, v in comm.by_op.items()})


def largest_collectives(comm: CommStats, k: int = 8) -> List[Tuple[str, int]]:
    """The k biggest single collectives (op, bytes)."""
    return sorted(comm.sizes, key=lambda t: -t[1])[:k]


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _flops(formula, args, kwargs, out) -> int:
    """``formula`` (``FlopCounterMode``'s, for ``func``'s packet) of one
    call.  An ``out_dtype`` overload (``mm.dtype``, ``bmm.dtype``: a bf16
    product with a float32 result) passes its dtype where the formula
    takes its output shape: the formula then gets the operands alone."""
    try:
        return formula(*args, **kwargs, out_val=out)
    except TypeError:
        return formula(*(a for a in args if isinstance(a, torch.Tensor)), out_val=out)


class Census(TorchDispatchMode):
    """Counts, while entered, every aten operator run on a rank's local
    tensors (``ops``: name -> calls), their FLOPs (``flops``) and the bytes
    the non-view ones read and write (``bytes``).  Views, allocations,
    queries that make no tensor and collectives move no bytes here
    (collectives are counted apart).  The
    operators DTensor runs to propagate shapes, under a fake mode of its
    own, are not counted (``MemTracker``'s rule)."""

    def __init__(self):
        super().__init__()
        self.ops: Counter = Counter()
        self.flops = 0
        self.bytes = 0

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(t is DTensor or issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor lowers it first, into local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_on_entry:
            return out
        name = func.__name__.split(".")[0]
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(_flops(formula, args, kwargs, out))
        self.ops[name] += 1
        written = _tensor_bytes(out)
        if (written and not func.is_view and not name.startswith("empty")
                and getattr(func, "namespace", "") not in COLLECTIVE_NAMESPACES):
            self.bytes += (_tensor_bytes(list(args)) + _tensor_bytes(list(kwargs.values()))
                           + written)
        return out

    def op_census(self, k: int = 12) -> List[Tuple[str, int]]:
        return self.ops.most_common(k)
