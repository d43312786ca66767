"""Atomic on-disk checkpoints of a flat list of numpy arrays.

Layout (one directory per step):

    <dir>/step_000000123/
        MANIFEST.json       # step, wall time, each leaf's shape and dtype
        arr_<idx>.npy       # one file per leaf
        _COMMITTED          # written last: a save without it is ignored

``save`` writes into ``step_x.tmp``, adds the commit marker and renames
the directory into place, so a crash mid-save never corrupts the newest
committed step; it keeps the newest ``keep`` steps.  ``restore`` loads
the newest committed step (or the one asked for) as a list of arrays in
save order.  The callers (the engine's segment checkpoints, the result
cache's disk tier) give their leaves a fixed order; no tree structure is
stored.  ``save_tree`` / ``restore_tree`` store a tree's leaves in the JAX
package's leaf order (``models/common.tree_flatten``: dict keys sorted,
lists and NamedTuples such as ``AdamWState`` in order), so a checkpoint the
JAX package wrote of the same tree restores into the port and back.

A tree of DTensors (mesh training) is saved whole: every rank of the mesh
gathers each leaf (``full_tensor``), the mesh's first rank writes it, and
the others wait at a barrier until the step is committed; the layout on
disk is the same, so such a checkpoint restores into any mesh shape, or
none.  ``restore_resharded`` places a checkpoint on a mesh: each rank reads
the whole arrays and keeps its own shard of each.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import tree_flatten, tree_unflatten

PathLike = Union[str, Path]

_MARKER = "_COMMITTED"


def _step_dir(ckpt_dir: Path, step: int) -> Path:
    return ckpt_dir / f"step_{step:09d}"


def save(ckpt_dir: PathLike, step: int, leaves: Sequence, *, keep: int = 3) -> Path:
    """Write ``leaves`` (arrays or tensors, each brought to the host) as
    step ``step``; atomic, keeps the newest ``keep`` committed steps."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final.with_name(final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": int(step), "time": time.time(), "leaves": []}
    for i, leaf in enumerate(leaves):
        if hasattr(leaf, "detach"):  # a torch tensor, on any device
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        np.save(tmp / f"arr_{i}.npy", arr)
        manifest["leaves"].append(
            {"idx": i, "shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(tmp / "MANIFEST.json", "w") as f:
        json.dump(manifest, f)
    (tmp / _MARKER).touch()
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    for s in sorted(committed_steps(ckpt_dir))[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
    return final


def committed_steps(ckpt_dir: PathLike) -> List[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return [int(p.name[5:]) for p in ckpt_dir.iterdir()
            if p.name.startswith("step_") and not p.name.endswith(".tmp")
            and (p / _MARKER).exists()]


def latest_step(ckpt_dir: PathLike) -> Optional[int]:
    steps = committed_steps(ckpt_dir)
    return max(steps) if steps else None


def restore(ckpt_dir: PathLike, step: Optional[int] = None
            ) -> Tuple[List[np.ndarray], int]:
    """(leaves in save order, step) of the newest committed step, or of
    ``step``."""
    ckpt_dir = Path(ckpt_dir)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    path = _step_dir(ckpt_dir, step)
    with open(path / "MANIFEST.json") as f:
        manifest = json.load(f)
    return [np.load(path / f"arr_{e['idx']}.npy") for e in manifest["leaves"]], step


def save_tree(ckpt_dir: PathLike, step: int, tree: Any, *, keep: int = 3) -> Path:
    """``save`` of the tree's leaves in the JAX package's leaf order.  DTensor
    leaves are gathered one at a time on every rank of their mesh (each rank
    must call this), written by the mesh's first rank; every rank returns
    once the step is committed."""
    leaves = tree_flatten(tree)[0]
    mesh = next((x.device_mesh for x in leaves if isinstance(x, DTensor)), None)
    if mesh is None:
        return save(ckpt_dir, step, leaves, keep=keep)
    from repro_torch.launch.mesh import barrier

    whole = (x.full_tensor() if isinstance(x, DTensor) else x for x in leaves)
    if not any(mesh.get_coordinate()):
        save(ckpt_dir, step, whole, keep=keep)
    else:
        for _ in whole:  # take part in each gather
            pass
    barrier(mesh)
    return _step_dir(Path(ckpt_dir), step)


def restore_tree(ckpt_dir: PathLike, template: Any, step: Optional[int] = None
                 ) -> Tuple[Any, int]:
    """(a tree shaped like ``template``, step) from the newest committed
    step, or ``step``.  Each leaf takes its template leaf's shape (checked),
    dtype, device and ``requires_grad``."""
    arrs, step = restore(ckpt_dir, step)
    tmpl, treedef = tree_flatten(template)
    if len(arrs) != len(tmpl):
        raise ValueError(f"checkpoint step {step} holds {len(arrs)} leaves, the "
                         f"template {len(tmpl)}")
    leaves = []
    for i, (a, t) in enumerate(zip(arrs, tmpl)):
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"leaf {i}: shape {tuple(a.shape)} in the checkpoint, "
                             f"{tuple(t.shape)} in the template")
        x = torch.from_numpy(a).to(device=t.device, dtype=t.dtype)
        leaves.append(x.requires_grad_() if t.requires_grad else x)
    return tree_unflatten(treedef, leaves), step


def restore_resharded(ckpt_dir: PathLike, template: Any, placements_tree: Any, mesh,
                      step: Optional[int] = None) -> Tuple[Any, int]:
    """(a tree shaped like ``template``, step) with each leaf placed on
    ``mesh`` by its placements in ``placements_tree`` (a tree of the
    template's structure, as ``distributed.sharding.params_sharding`` gives
    one; ``None`` keeps a leaf a plain tensor): every rank reads the whole
    arrays and keeps its own shard of each, so a checkpoint written on one
    mesh shape, or none, restores onto another.  Dtypes, devices and
    ``requires_grad`` come from the template's leaves (DTensors or not),
    and their global shapes are checked."""
    from repro_torch.distributed.ctx import local_shard
    from repro_torch.distributed.sharding import placement_leaves

    arrs, step = restore(ckpt_dir, step)
    tmpl, treedef = tree_flatten(template)
    places = placement_leaves(placements_tree)
    if not len(arrs) == len(tmpl) == len(places):
        raise ValueError(f"checkpoint step {step} holds {len(arrs)} leaves, the "
                         f"template {len(tmpl)}, the placements {len(places)}")
    out = []
    for i, (a, t, pl) in enumerate(zip(arrs, tmpl, places)):
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"leaf {i}: shape {tuple(a.shape)} in the checkpoint, "
                             f"{tuple(t.shape)} in the template")
        x = torch.from_numpy(a)
        if pl is None:
            x = x.to(device=t.device, dtype=t.dtype)
        else:  # the shard is cut on the host: only it goes to the card
            x = local_shard(x, mesh, pl).to(device=t.device, dtype=t.dtype).contiguous()
            x = DTensor.from_local(x, mesh, pl, run_check=False)
        out.append(x.requires_grad_() if t.requires_grad else x)
    return tree_unflatten(treedef, out), step


def clear(ckpt_dir: PathLike) -> None:
    """Remove a checkpoint directory and everything in it; a missing one is
    a no-op."""
    shutil.rmtree(Path(ckpt_dir), ignore_errors=True)


def scan(root: PathLike) -> List[str]:
    """Names of the child directories of ``root`` that hold a committed
    step: the keys a keyed store (the result cache's disk tier) can serve."""
    root = Path(root)
    if not root.exists():
        return []
    return sorted(p.name for p in root.iterdir()
                  if p.is_dir() and latest_step(p) is not None)
