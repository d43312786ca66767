"""Multi-pod dry-run launcher (the port's ``src/repro/launch/dryrun.py``).

For every assigned (architecture x input-shape) cell, on the single-pod
(16x16) and multi-pod (2x16x16) production meshes, the cell's
``build_step`` bundle runs once as rank 0 of a fake world of 256 or 512
ranks (``launch.mesh.fake_world``: collectives return at once, moving
nothing) under ``FakeTensorMode`` (tensors with shapes and a device, no
storage: nothing is allocated and no kernel is launched) and
``ctx.use_rules``.  Where the JAX launcher reads XLA's compiled program,
this one counts what the traced rank runs:

* memory: the peak of the rank's live tensors over arguments,
  temporaries and outputs (``MemTracker``), XLA's ``memory_analysis``;
* FLOPs: ``FlopCounterMode``'s formulas over every operator on the rank's
  local tensors; bytes accessed and the op census
  (``analysis.census.Census``), XLA's ``cost_analysis``;
* collectives: ``sharding.count_collectives`` by op and the largest ones,
  the JAX launcher's HLO parse;

and turns them into roofline terms with the H100's constants
(``analysis.roofline``).  Records go to
``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``.

An eager trace runs every layer and every microbatch, so the counts are
whole: XLA counts a ``while`` body once and the JAX launcher extrapolates
from unrolled variants (``scan_corrected_costs``, ``utils/unroll.py``);
here ``scan_corrected`` is always false and no correction exists, so
``--no-correction`` (``dryrun_cell(correct=False)``), the JAX launcher's
switch for its multi-pod pass, is accepted and changes nothing.

The kernels are ``repro_torch::`` operators with fake implementations
(``kernels/_launch.py``), so a trace with fake CUDA tensors goes through
them as through any other operator: the fleet DSE evaluation on the
``kernel`` backend (``--search-mesh SxP --backend kernel``) traces B1's
operator, as the JAX launcher's ``backend="pallas"`` lowers its Pallas
kernel.  The LM cells trace the plain attention and SSD (``impl="kernel"``
is refused): the JAX launcher lowers ``attn_impl="jnp"`` only, and the
training step has no backward kernel.  Fake CUDA tensors need no card,
and no torch built with CUDA either (``fake_cuda_guard``).

Usage:
    python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
    python -m repro_torch.launch.dryrun --paper          # DSE generation dry-run
    python -m repro_torch.launch.dryrun --paper --search-mesh 64x8
    python -m repro_torch.launch.dryrun --search-mesh 2x1 --backend kernel --no-save
    (fake tensors claim --device cuda by default and need no card; --device
    cpu traces the CPU's paths, which the kernel backend does not have)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.analysis.census import Census, collective_stats, largest_collectives
from repro_torch.analysis.roofline import model_flops, roofline_terms
from repro_torch.distributed import ctx as dist_ctx
from repro_torch.distributed import sharding
from repro_torch.launch.cells import Cell, StepBundle, all_cells, build_step, map_placed, \
    skipped_cells
from repro_torch.launch.mesh import describe, fake_world, make_production_mesh, \
    make_search_mesh
from repro_torch.models.common import tree_flatten

DOC = __doc__

RESULT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

NO_KERNEL_IN_CELLS = (
    "the LM cells trace the plain attention and SSD: the JAX launcher lowers "
    "attn_impl='jnp' only (its cells have no kernel switch), and the training step has no "
    "backward kernel (train/step.py)")

SINGLE, MULTI = "single-pod", "multi-pod"


_GUARD_STANDIN = []
_CUDA = 1  # c10::DeviceType::CUDA, the CUDA slot of c10's guard registry


def fake_cuda_guard() -> None:
    """Let fake CUDA tensors through a torch built without CUDA.

    Python's indexing, ``.contiguous()`` and a few other bindings enter a
    device guard for their tensor's device before they dispatch, so a fake
    ``cuda`` tensor needs a CUDA guard even though nothing runs on a card.
    A torch built with CUDA has one, and nothing is done there.  On a host
    without cards ``FakeTensorMode`` swaps in c10's no-op
    ``FakeGuardImpl<CUDA>`` itself (``torch._C._ensureCUDADeviceGuardSet``),
    but that swap only replaces a registered guard that reports no devices,
    and a torch built without CUDA registers none.  So this registers a
    stand-in whose every virtual method returns 0 (so its device count is
    0), lets the swap put c10's no-op guard in its place, and reads the
    registry's CUDA slot back: if the stand-in is still there, it clears
    the slot again and raises, so no guard call ever reaches the stand-in.
    Idempotent."""
    import ctypes
    import os

    if torch.cuda._is_compiled() or _GUARD_STANDIN:
        return
    c10 = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib", "libc10.so"))
    register = c10._ZN3c104impl19registerDeviceGuardENS_10DeviceTypeEPKNS0_24DeviceGuardImplInterfaceE
    register.argtypes, register.restype = [ctypes.c_int8, ctypes.c_void_p], None
    registry = ctypes.addressof(
        ctypes.c_void_p.in_dll(c10, "_ZN3c104impl26device_guard_impl_registryE"))
    slot = ctypes.c_void_p.from_address(registry + _CUDA * ctypes.sizeof(ctypes.c_void_p))
    zero = ctypes.CFUNCTYPE(ctypes.c_int64)(lambda: 0)
    vtable = (ctypes.c_void_p * 64)(*[ctypes.cast(zero, ctypes.c_void_p).value] * 64)
    standin = (ctypes.c_void_p * 1)(ctypes.addressof(vtable))
    register(_CUDA, ctypes.addressof(standin))
    torch._C._ensureCUDADeviceGuardSet()
    if slot.value in (None, ctypes.addressof(standin)):
        register(_CUDA, None)
        raise RuntimeError(
            f"torch {torch.__version__} did not replace the stand-in CUDA device guard "
            "with its no-op one: fake CUDA tensors need a torch built with CUDA here "
            "(or --device cpu)")
    _GUARD_STANDIN.extend((zero, vtable, standin))  # kept alive, never called


def fake_mode(device: str = "cuda"):
    """A ``FakeTensorMode`` whose fake tensors may stand for data-dependent
    values (DTensor reads a split's offsets with ``tolist`` when it
    gathers a strided shard: a ``ShapeEnv`` gives them symbols), and which
    takes the few real tensors DTensor keeps (a mesh's coordinates).  Fake
    tensors on a CUDA ``device`` work on a torch built without CUDA
    (``fake_cuda_guard``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    if torch.device(device).type == "cuda":
        fake_cuda_guard()
    return FakeTensorMode(allow_non_fake_inputs=True, shape_env=ShapeEnv())


@contextlib.contextmanager
def _propagation_apart():
    """DTensor derives each operator's output shape by running it on fake
    tensors of the global shapes, in the active fake mode, which in a
    dry-run is the trace's own: the memory tracker and the census would
    count those global tensors as the rank's.  Inside this context that
    derivation runs with every dispatch mode popped (in a fake mode of its
    own), where no counter sees it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.utils._python_dispatch import _disable_current_modes

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def apart(self, op_schema):
        with _disable_current_modes():
            return orig(self, op_schema)

    ShardingPropagator._propagate_tensor_meta_non_cached = apart
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


def _fake_args(bundle: StepBundle, device: str) -> tuple:
    """The bundle's arguments as fake tensors on ``device`` (entered fake
    mode): a DTensor leaf's local shard made directly, at its local shape."""
    def one(a, places):
        if isinstance(a, DTensor):
            local = torch.empty(a.to_local().shape, dtype=a.dtype, device=device)
            return DTensor.from_local(local, a.device_mesh, a.placements, run_check=False,
                                      shape=a.shape, stride=a.stride())
        return torch.empty(a.shape, dtype=a.dtype, device=device)

    return tuple(map_placed(one, a, p) for a, p in zip(bundle.args, bundle.in_placements))


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storage(t: torch.Tensor) -> int:
    """The identity of ``t``'s storage (its C++ object's address)."""
    return t.untyped_storage()._cdata


def trace_step(bundle: StepBundle, device: str,
               rules: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run one bundle once on fake tensors and count what its rank runs:
    {"trace_s", "memory": {argument, output, alias, temp, peak bytes},
    "flops", "bytes", "census" (Census), "comm" (a ``CommStats`` copy)}.
    On a mesh the caller has made the (fake) world; ``rules`` default to
    ``make_rules(bundle.mesh)``."""
    from torch.distributed._tools.mem_tracker import MemTracker

    mesh = bundle.mesh
    scope = dist_ctx.use_rules(mesh, rules or sharding.make_rules(mesh)) if mesh is not None \
        else contextlib.nullcontext()
    with _propagation_apart(), fake_mode(device):
        args = _fake_args(bundle, device)
        arg_locals = [_local(x) for x in tree_flatten(args)[0]]
        tracker = MemTracker()
        tracker.track_external(*arg_locals)
        census = Census()
        sharding.COMM.reset()
        t0 = time.perf_counter()
        with scope, tracker, census, sharding.count_collectives():
            out = bundle.fn(*args)
        trace_s = time.perf_counter() - t0
        peak = sum(snap.get("Total", 0) for snap in tracker.get_tracker_snapshot("peak").values())
        outs = [_local(x) for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
    arg_st = {_storage(t) for t in arg_locals}
    alias = _nbytes(t for t in outs if _storage(t) in arg_st)
    arg_b, out_b = _nbytes(arg_locals), _nbytes(outs)
    comm = sharding.CommStats(calls=sharding.COMM.calls, bytes=sharding.COMM.bytes,
                              by_op=dict(sharding.COMM.by_op), sizes=list(sharding.COMM.sizes))
    return {"trace_s": trace_s, "flops": census.flops, "bytes": census.bytes, "census": census,
            "comm": comm,
            "memory": {"argument_bytes": arg_b, "output_bytes": out_b, "alias_bytes": alias,
                       "temp_bytes": peak - arg_b - out_b + alias, "peak_bytes": peak}}


def _check_impl(build_kwargs: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    kw = dict(build_kwargs or {})
    if kw.get("impl", "plain") != "plain":
        raise ValueError(NO_KERNEL_IN_CELLS)
    return kw


def _write(mesh_name: str, filename: str, rec: Dict[str, Any], out_dir: Path) -> None:
    out = Path(out_dir) / mesh_name
    out.mkdir(parents=True, exist_ok=True)
    with open(out / filename, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def dryrun_cell(
    cell: Cell,
    mesh,
    *,
    save: bool = True,
    keep_census: bool = False,
    build_kwargs: Optional[Dict[str, Any]] = None,
    device: str = "cuda",
    out_dir: Path = RESULT_DIR,
    correct: bool = True,
) -> Dict[str, Any]:
    """Trace one cell on one mesh (inside its fake world; ``None``:
    meshless, one card) and return the record dict (the JAX record's keys,
    ``compile_s`` -> ``trace_s``).  ``keep_census`` keeps the whole op
    census (the JAX launcher's ``keep_hlo``).  ``correct`` has no effect:
    the trace counts every layer, so there is nothing to extrapolate, and
    the record's ``scan_corrected`` is false either way."""
    kw = _check_impl(build_kwargs)
    cfg, shape = cell.cfg, cell.shape
    mesh_name = describe(mesh) if mesh is not None else "meshless"
    bundle = build_step(cfg, shape, mesh, **kw)
    rules = sharding.make_rules(mesh, kw.get("sharding_overrides")) if mesh is not None else None
    t = trace_step(bundle, device, rules)
    coll = collective_stats(t["comm"])
    chips = int(mesh.mesh.numel()) if mesh is not None else 1
    mfl = model_flops(cfg, shape)
    mem = t["memory"]
    rf = roofline_terms(cell=cell.name, mesh_name=mesh_name, chips=chips, flops=t["flops"],
                        bytes_accessed=t["bytes"], coll=coll, model_flops_global=mfl,
                        mem_per_device=mem["peak_bytes"])
    rec = {
        "cell": cell.name,
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh_name,
        "chips": chips,
        "device": device,
        "ok": True,
        "trace_s": round(t["trace_s"], 2),
        "scan_corrected": False,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "memory": {
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "temp_bytes": mem["temp_bytes"],
            "alias_bytes": mem["alias_bytes"],
            "per_device_bytes": mem["peak_bytes"],
            "per_device_gb": round(mem["peak_bytes"] / 2**30, 3),
        },
        "cost": {
            "flops_per_device": t["flops"],
            "bytes_per_device": t["bytes"],
            "flops_per_device_raw": t["flops"],
            "bytes_per_device_raw": t["bytes"],
            "model_flops_global": mfl,
        },
        "collectives": {
            "total_bytes": coll.total_bytes,
            "total_bytes_raw": coll.total_bytes,
            "by_kind": coll.by_kind,
            "counts": coll.counts,
            "largest": largest_collectives(t["comm"]),
        },
        "roofline": {
            "t_compute_s": rf.t_compute,
            "t_memory_s": rf.t_memory,
            "t_collective_s": rf.t_collective,
            "bottleneck": rf.bottleneck,
            "useful_ratio": rf.useful_ratio,
            "peak_fraction": rf.peak_fraction,
        },
        "op_census_top": t["census"].op_census(12),
    }
    if keep_census:
        rec["op_census"] = dict(t["census"].ops)
    if save:
        _write(mesh_name, f"{cfg.name}__{shape.name}.json", rec, out_dir)
    return rec


def _paper_ws():
    from repro_torch.workloads.cnn import PAPER_WORKLOADS, cnn_workload
    from repro_torch.workloads.pack import pack_workloads

    return pack_workloads([(n, cnn_workload(n)) for n in PAPER_WORKLOADS])


@contextlib.contextmanager
def _device_caches_kept():
    """The search path keeps device copies of its grids in module caches
    keyed by device (``core.space``, ``imc.cost``, ``core.engine``): what a
    fake trace adds there (fake tensors) is dropped again on exit."""
    from repro_torch.core import engine, space
    from repro_torch.imc import cost
    from repro_torch.kernels.ga_gen_step import ops as gops

    caches = (space._DEVICE_GRIDS, cost._VT_CACHE, engine._VT_CDF, gops._GRID_ARGS)
    saved = [dict(c) for c in caches]
    try:
        yield
    finally:
        for c, d in zip(caches, saved):
            c.clear()
            c.update(d)


def _trace_fn(fn, device: str, *shapes) -> Dict[str, Any]:
    """``fn`` of fake float32 tensors of ``shapes`` on ``device``: (FLOPs,
    bytes, collective bytes) of the traced rank."""
    with _device_caches_kept(), _propagation_apart(), fake_mode(device):
        args = [torch.empty(s, dtype=torch.float32, device=device) for s in shapes]
        census = Census()
        sharding.COMM.reset()
        with census, sharding.count_collectives():
            fn(*args)
    return {"flops_per_device": float(census.flops), "bytes_per_device": float(census.bytes),
            "collective_bytes": sharding.COMM.bytes}


def dryrun_paper_search(mesh, *, pop_size: int = 4096, save: bool = True,
                        device: str = "cuda", out_dir: Path = RESULT_DIR) -> Dict[str, Any]:
    """Trace one evaluation of the paper's DSE population (the 4 CNNs,
    ``ela``, 150 mm^2) on the dense path, the population split over the
    mesh's data axes (``core.distributed.sharded_eval_fn``)."""
    from repro_torch.core import space
    from repro_torch.core.distributed import sharded_eval_fn

    ev = sharded_eval_fn(mesh, _paper_ws(), "ela", 150.0)
    rec = {"cell": f"paper-dse/pop{pop_size}", "mesh": describe(mesh), "ok": True,
           **_trace_fn(ev, device, (pop_size, space.N_GENES))}
    if save:
        _write(describe(mesh), f"paper-dse__pop{pop_size}.json", rec, out_dir)
    return rec


def dryrun_paper_search_batched(
    mesh, *, searches: Optional[int] = None, pop_size: int = 1024, save: bool = True,
    backend: str = "dense", device: str = "cuda", out_dir: Path = RESULT_DIR,
) -> Dict[str, Any]:
    """Trace the fleet DSE evaluation: B independent searches' populations,
    this rank's rows of the batch (``search`` axis) and its share of each
    population (``data`` axis), through ``sharded_batched_eval_fn`` on the
    ``dense`` cost model, the factorized ``table`` evaluator, or the
    ``kernel`` backend, whose layer sums are B1's operator
    (``repro_torch::imc_eval``, on fake CUDA tensors: the JAX launcher's
    ``backend="pallas"``)."""
    from repro_torch.core import space
    from repro_torch.core.distributed import place_batched, sharded_batched_eval_fn
    from repro_torch.launch.mesh import mesh_axis_sizes

    if backend not in ("dense", "table", "kernel"):
        raise ValueError(f"backend must be dense, table or kernel, got {backend!r}")
    if backend == "kernel" and torch.device(device).type != "cuda":
        raise ValueError("backend='kernel' traces B1's operator, which runs on CUDA "
                         f"tensors: device must be cuda, got {device!r}")
    ws = _paper_ws()
    B = searches or mesh_axis_sizes(mesh).get("search", 1)
    ev = sharded_batched_eval_fn(mesh, "ela", 150.0, backend=backend)
    if backend == "table":
        tables = ws.tables()

        def run(genomes):  # inside the fake mode: the tables' leaves, fake
            ctx = (type(tables)(*(torch.empty((B,) + tuple(t.shape), dtype=t.dtype,
                                              device=device) for t in tables)),)
            rows = place_batched(mesh, genomes)
            return ev(rows, tuple(type(c)(*(place_batched(mesh, t) for t in c)) for c in ctx))
    else:
        def run(genomes):  # inside the fake mode: the workloads, fake
            feats = torch.empty((B,) + tuple(ws.feats.shape), device=device)
            mask = torch.empty((B,) + tuple(ws.mask.shape), dtype=torch.bool, device=device)
            return ev(place_batched(mesh, genomes),
                      (place_batched(mesh, feats), place_batched(mesh, mask)))

    rec = {"cell": f"paper-dse-fleet/b{B}xpop{pop_size}/{backend}", "mesh": describe(mesh),
           "ok": True, "searches": B, "backend": backend,
           **_trace_fn(run, device, (B, pop_size, space.N_GENES))}
    if save:
        tag = "" if backend == "dense" else f"__{backend}"
        _write(describe(mesh), f"paper-dse-fleet__b{B}xpop{pop_size}{tag}.json", rec, out_dir)
    return rec


def _meshes(which: str):
    out = []
    if which in ("single", "both"):
        out.append((SINGLE, False, 256))
    if which in ("multi", "both"):
        out.append((MULTI, True, 512))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=DOC,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--search-mesh", default=None, metavar="SxP",
                    help="(search, population) mesh, e.g. 64x8: dry-run the fleet DSE "
                         "layout instead of the production meshes (implies --paper)")
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--paper", action="store_true", help="dry-run the DSE eval")
    ap.add_argument("--backend", default="dense", choices=["dense", "table", "kernel"],
                    help="cost-model backend of the --search-mesh fleet dry-run (kernel: "
                         "B1's operator, on --device cuda)")
    ap.add_argument("--device", default="cuda",
                    help="device the fake tensors claim (no card is used, nor a torch "
                         "built with CUDA); 'cpu' traces the CPU's paths")
    ap.add_argument("--out", default=str(RESULT_DIR), help="records directory")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--no-correction", action="store_true",
                    help="the JAX launcher's switch to skip its unrolled cost extrapolation; "
                         "no effect here (an eager trace counts every layer)")
    args = ap.parse_args(argv)
    save, out_dir, dev = not args.no_save, Path(args.out), args.device

    if args.search_mesh:
        s, p = (int(v) for v in args.search_mesh.lower().split("x"))
        with fake_world(s * p, dev):
            mesh = make_search_mesh(s, p, device_type=dev)
            rec = dryrun_paper_search_batched(mesh, save=save, backend=args.backend,
                                              device=dev, out_dir=out_dir)
        print(f"[paper-dse-fleet {rec['mesh']}] ok searches={rec['searches']} "
              f"backend={rec['backend']} flops/dev={rec['flops_per_device']:.3e} "
              f"bytes/dev={rec['bytes_per_device']:.3e} "
              f"coll={rec['collective_bytes'] / 1e6:.0f}MB")
        return 0

    if args.paper:
        for label, multi, n in _meshes(args.mesh):
            with fake_world(n, dev):
                rec = dryrun_paper_search(make_production_mesh(multi_pod=multi, device_type=dev),
                                          save=save, device=dev, out_dir=out_dir)
            print(f"[paper-dse {label}] ok  flops/dev={rec['flops_per_device']:.3e} "
                  f"bytes/dev={rec['bytes_per_device']:.3e}")
        return 0

    cells = all_cells(args.arch, args.shape)
    if not cells:
        print("no cells selected", file=sys.stderr)
        return 2

    failures = []
    for label, multi, n in _meshes(args.mesh):
        with fake_world(n, dev):
            mesh = make_production_mesh(multi_pod=multi, device_type=dev)
            for cell in cells:
                tag = f"[{cell.name} @ {label}]"
                try:
                    rec = dryrun_cell(cell, mesh, save=save, device=dev, out_dir=out_dir,
                                      correct=not args.no_correction)
                    r = rec["roofline"]
                    print(f"{tag} OK mem/dev={rec['memory']['per_device_gb']:.2f}GB "
                          f"flops/dev={rec['cost']['flops_per_device']:.3e} "
                          f"coll={rec['collectives']['total_bytes'] / 1e6:.0f}MB "
                          f"bottleneck={r['bottleneck']} (trace {rec['trace_s']:.1f}s)",
                          flush=True)
                except Exception as e:  # noqa: BLE001 - report, continue, fail at the end
                    failures.append((cell.name, label, repr(e)))
                    print(f"{tag} FAIL {e!r}", flush=True)
                    traceback.print_exc()

    skips = skipped_cells()
    if skips:
        print("\nintentional skips:")
        for a, s, why in skips:
            print(f"  {a} x {s}: {why}")
    if failures:
        print(f"\n{len(failures)} FAILURES", file=sys.stderr)
        return 1
    print(f"\nall {len(cells)} cells x {len(_meshes(args.mesh))} meshes OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
