"""Workload packing: list-of-layer-tables -> padded tensors.

A set of W workloads becomes
    feats (W, L_max, 6) float32   and   mask (W, L_max) bool
so the joint ``max_w`` reduction and the per-layer cost sums are tensor
ops.  The tensors live on the host; the engine moves them to its device.
``WorkloadSet.fingerprint()`` is a content hash over the same bytes as the
JAX package's ``WorkloadSet.fingerprint()``, so cache keys agree across
the two packages.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Sequence, Tuple

import numpy as np
import torch


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
