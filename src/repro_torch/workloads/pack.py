"""Workload packing: list-of-layer-tables -> padded tensors.

A set of W workloads becomes
    feats (W, L_max, 6) float32   and   mask (W, L_max) bool
so the joint ``max_w`` reduction and the per-layer cost sums are tensor
ops.  The tensors live on the host; the engine moves them to its device.
``WorkloadSet.fingerprint()`` is a content hash over the same bytes as the
JAX package's ``WorkloadSet.fingerprint()``, so cache keys agree across
the two packages.  ``WorkloadSet.tables()`` memoizes the factorized cost
tables (``imc.tables``) on that hash: the layer axis is reduced once per
(content, tech, grid), and a re-packed identical set hits the same entry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from collections import OrderedDict
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import spans

# (fingerprint, tech, grid token) -> WorkloadTables on the CPU.  Keyed by
# content, not by object, and capped: a service's request stream can carry
# any number of distinct sets, so the memo is an LRU (a re-access
# refreshes, overflow evicts the oldest, an evicted entry rebuilds).  The
# cap is read per call from REPRO_TABLES_MEMO_CAP (entries).
_TABLES_MEMO: "OrderedDict[tuple, object]" = OrderedDict()
_TABLES_MEMO_CAP_ENV = "REPRO_TABLES_MEMO_CAP"
_TABLES_MEMO_CAP_DEFAULT = 1024


def _tables_memo_cap() -> int:
    cap = int(os.environ.get(_TABLES_MEMO_CAP_ENV, _TABLES_MEMO_CAP_DEFAULT))
    if cap < 1:
        raise ValueError(f"{_TABLES_MEMO_CAP_ENV} must be >= 1, got {cap}")
    return cap


@dataclasses.dataclass(frozen=True)
class WorkloadSet:
    names: Tuple[str, ...]
    feats: torch.Tensor  # (W, L_max, 6) float32
    mask: torch.Tensor  # (W, L_max) bool

    @property
    def n(self) -> int:
        return len(self.names)

    def subset(self, idx: Sequence[int]) -> "WorkloadSet":
        idx = list(idx)
        sel = torch.as_tensor(idx, dtype=torch.long)
        return WorkloadSet(
            names=tuple(self.names[i] for i in idx),
            feats=self.feats[sel],
            mask=self.mask[sel],
        )

    def fingerprint(self) -> str:
        """sha256 over the feats/mask bytes (+ shapes, so equal byte
        streams of different layouts can't collide) and the workload
        names.  Cached on the instance after the first call."""
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            h = hashlib.sha256()
            feats = np.ascontiguousarray(
                self.feats.detach().cpu().numpy().astype(np.float32, copy=False))
            mask = np.ascontiguousarray(
                self.mask.detach().cpu().numpy().astype(bool, copy=False))
            h.update(repr((feats.shape, mask.shape)).encode())
            h.update(feats.tobytes())
            h.update(mask.tobytes())
            h.update("\x00".join(self.names).encode())
            fp = h.hexdigest()
            self.__dict__["_fingerprint"] = fp
        return fp

    def tables(self, tech=None):
        """The set's ``imc.tables.WorkloadTables`` (CPU tensors, leading
        dim W), built from its own feats and memoized on ``(fingerprint,
        tech, grid token)``.  The engine stacks these per request, so a
        request scores with the same tables alone or in any batch."""
        from repro_torch.core import space
        from repro_torch.imc.tables import build_tables_arrays
        from repro_torch.imc.tech import TECH

        tech = tech or TECH
        key = (self.fingerprint(), tech, space.grid_token())
        hit = _TABLES_MEMO.get(key)
        if hit is None:
            with spans.span("tables.build", key="workload_set"):
                hit = _TABLES_MEMO[key] = build_tables_arrays(
                    self.feats.cpu(), self.mask.cpu(), tech)
        _TABLES_MEMO.move_to_end(key)
        cap = _tables_memo_cap()
        while len(_TABLES_MEMO) > cap:
            _TABLES_MEMO.popitem(last=False)
        return hit


def pack_workloads(named_layers: Sequence[Tuple[str, List[Tuple]]]) -> WorkloadSet:
    l_max = max(len(ls) for _, ls in named_layers)
    W = len(named_layers)
    feats = np.zeros((W, l_max, 6), np.float32)
    mask = np.zeros((W, l_max), bool)
    for i, (_, ls) in enumerate(named_layers):
        feats[i, : len(ls)] = np.asarray(ls, np.float32)
        mask[i, : len(ls)] = True
    return WorkloadSet(
        names=tuple(n for n, _ in named_layers),
        feats=torch.from_numpy(feats),
        mask=torch.from_numpy(mask),
    )
