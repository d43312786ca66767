"""Carry the JAX package's state across to the port.

The "weights" of this system are its technology constants, its workload
sets, its factorized tables and a GA state (population and scores).
Each function takes them as plain dicts or numpy arrays (anything
``np.asarray`` accepts, the reference's arrays included), copies them,
and returns the port's objects on the given device.  Nothing here
imports the JAX package.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.imc.tables import WorkloadTables
from repro_torch.imc.tech import TechParams
from repro_torch.workloads.pack import WorkloadSet

ArrayLike = Union[np.ndarray, Sequence]


def tech_from_dict(fields: Mapping[str, float]) -> TechParams:
    """``TechParams`` from a field dict, e.g. the reference's
    ``TECH._asdict()``.  Unknown fields raise."""
    unknown = set(fields) - set(TechParams._fields)
    if unknown:
        raise ValueError(f"unknown TechParams fields: {sorted(unknown)}")
    return TechParams(**dict(fields))


def workload_set_from_arrays(names: Sequence[str], feats: ArrayLike,
                             mask: ArrayLike) -> WorkloadSet:
    """A host ``WorkloadSet`` from (W, L, 6) feats and (W, L) mask."""
    f = np.ascontiguousarray(np.asarray(feats, np.float32))
    m = np.ascontiguousarray(np.asarray(mask, bool))
    if f.ndim != 3 or f.shape[-1] != 6 or m.shape != f.shape[:2]:
        raise ValueError(f"feats {f.shape} / mask {m.shape}: want (W, L, 6) / (W, L)")
    if len(names) != f.shape[0]:
        raise ValueError(f"{len(names)} names for {f.shape[0]} workloads")
    return WorkloadSet(names=tuple(names), feats=torch.from_numpy(f.copy()),
                       mask=torch.from_numpy(m.copy()))


def tables_from_arrays(leaves: Union[Mapping[str, ArrayLike], Sequence[ArrayLike]],
                       device="cuda") -> WorkloadTables:
    """``WorkloadTables`` from the reference's leaves, as a dict keyed by
    field name or a sequence in field order (a reference
    ``WorkloadTables`` is such a sequence)."""
    dev = resolve_device(device)
    if isinstance(leaves, Mapping):
        leaves = [leaves[f] for f in WorkloadTables._fields]
    if len(leaves) != len(WorkloadTables._fields):
        raise ValueError(f"want {len(WorkloadTables._fields)} leaves, got {len(leaves)}")
    return WorkloadTables(*(
        torch.as_tensor(np.array(x, np.float32), device=dev) for x in leaves))


def ga_state_from_arrays(genomes: ArrayLike, scores: ArrayLike, device="cuda"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A GA state ``(population (..., P, n), scores (..., P))`` on device."""
    dev = resolve_device(device)
    g = torch.as_tensor(np.array(genomes, np.float32), device=dev)
    s = torch.as_tensor(np.array(scores, np.float32), device=dev)
    if g.shape[:-1] != s.shape:
        raise ValueError(f"genomes {tuple(g.shape)} / scores {tuple(s.shape)} disagree")
    return g, s
