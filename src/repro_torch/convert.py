"""Carry the JAX package's state across to the port.

The "weights" of the search are its technology constants, its workload
sets, its factorized tables and a GA state (population and scores); those
of the LMs are their parameter trees and decode caches.  Each function
takes them as plain dicts, lists or numpy arrays (anything ``np.asarray``
accepts, the reference's arrays included, bfloat16 ones too), copies them,
and returns the port's objects on the given device; a training state (the
parameters and the AdamW state) also goes back to numpy trees of the JAX
package's structure, for comparisons.  Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.imc.tables import WorkloadTables
from repro_torch.imc.tech import TechParams
from repro_torch.models import transformer
from repro_torch.models.common import tree_flatten, tree_map, tree_unflatten
from repro_torch.optim import AdamWState
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


def tensor_from_numpy(x, device="cuda") -> torch.Tensor:
    """A copy of an array on ``device``; bfloat16 arrays (numpy has no
    native bfloat16: the reference's come as an extension dtype of that
    name) keep their bits."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(resolve_device(device))
    return torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def _tree_from_numpy(template, tree, device, where: str):
    if isinstance(template, dict):
        if not isinstance(tree, Mapping) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, Mapping) else type(tree).__name__
            raise ValueError(f"{where}: keys {got}, want {sorted(template)}")
        return {k: _tree_from_numpy(template[k], tree[k], device, f"{where}.{k}")
                for k in template}
    if isinstance(template, list):
        if len(tree) != len(template):
            raise ValueError(f"{where}: {len(tree)} entries, want {len(template)}")
        return [_tree_from_numpy(t, x, device, f"{where}[{i}]")
                for i, (t, x) in enumerate(zip(template, tree))]
    shape, dtype = template
    t = tensor_from_numpy(tree, device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)}, want {tuple(shape)}")
    return t.to(dtype)


def lm_params_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """The port's LM parameters from the JAX package's parameter tree as
    numpy arrays (``embed``, ``final_norm``, ``blocks`` stacked over
    ``n_blocks``, ``lm_head`` when untied), float32 on ``device``."""
    template = tree_map(lambda d: (d.shape, torch.float32), transformer.param_template(cfg))
    return _tree_from_numpy(template, tree, device, "params")


def adamw_state_from_numpy(cfg: ModelConfig, state, device="cuda") -> AdamWState:
    """The port's ``AdamWState`` from the JAX package's (a ``(step, mu,
    nu)`` triple, its ``AdamWState`` included, of numpy arrays): the step an
    int32 0-d tensor, the moments float32 trees of the parameters'
    structure, on ``device``."""
    step, mu, nu = state
    dev = resolve_device(device)
    return AdamWState(step=torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev),
                      mu=lm_params_from_numpy(cfg, mu, dev),
                      nu=lm_params_from_numpy(cfg, nu, dev))


def tree_to_numpy(tree):
    """A tree of tensors (the parameters, or an ``AdamWState``) as the same
    structure of numpy arrays on the host, in each leaf's dtype (bfloat16
    widened to float32)."""
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        (x.detach().float() if x.dtype == torch.bfloat16 else x.detach()).cpu().numpy()
        for x in leaves])


def lm_cache_from_numpy(cfg: ModelConfig, tree, device="cuda"):
    """The port's decode cache from the JAX package's (a list over the
    period's slots of ``{"k", "v"}`` (plus ``{"xk", "xv"}`` for enc-dec)
    or ``{"conv", "ssm"}`` arrays stacked over blocks), each leaf in its
    own dtype on ``device``.  The batch, the cache length and the cross-KV
    length (the encoder frames') are read from the arrays."""
    if not isinstance(tree, (list, tuple)) or not tree:
        raise ValueError("cache: want a list over the layer plan's slots")
    batch = np.asarray(next(iter(tree[0].values()))).shape[1]

    def length(key):
        return next((np.asarray(s[key]).shape[2] for s in tree if key in s), 1)

    self_len, cross_len = length("k"), length("xk")
    template = transformer.cache_template(cfg, batch, self_len)
    if cfg.is_encdec:
        cross = transformer.cache_template(cfg, batch, cross_len)
        for slot, xslot in zip(template, cross):
            for k in ("xk", "xv"):
                if k in slot:
                    slot[k] = xslot[k]
    template = [{k: (shape, tensor_from_numpy(tree[i][k], "cpu").dtype)
                 for k, (shape, _) in slot.items()} for i, slot in enumerate(template)]
    return _tree_from_numpy(template, list(tree), device, "cache")
