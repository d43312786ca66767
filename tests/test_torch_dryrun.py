"""The dry-run (``launch/dryrun.py``, ``launch/mesh.fake_world``,
``analysis/census.py``) and the roofline report (``launch/roofline.py``) on
the CPU, in fake worlds (``--device cpu``: fake tensors need no card).

* Every (family, kind) of ``tests/test_system.py::test_cell_lowers_on_test_mesh``
  (reduced llama3.2-1b, mamba2-780m, mixtral-8x7b; train, prefill,
  decode; S=64, B=4 so that a 2x2 mesh's two microbatches split) dry-runs
  at 1x1 and 2x2.  At 1x1 the counted FLOPs equal ``FlopCounterMode`` over
  the same step run on real tensors in a gloo world of one, and no
  collective moves a byte; for prefill and decode they also equal
  ``FlopCounterMode`` over the real meshless step (the bundle of
  ``build_step(cfg, shape, None)``).  A train step on a mesh computes one
  more product per layer and microbatch than the meshless one: remat's
  recomputation stops once every saved tensor is back, which autograd
  saves for the meshless down projection before its product runs and
  ``ctx._Project`` after.  At 2x2 collectives move bytes and the peak per
  device is below 1x1's.
* FLOPs, bytes and collective bytes are exactly linear in ``n_blocks``:
  f(3) - f(2) = f(2) - f(1), what XLA needed ``utils/unroll.py`` and its
  extrapolation for (an eager trace counts every layer).
* ``main`` over llama's inference cells (reduced widths, the assigned
  shapes) on both production meshes returns 0 with four OK lines; a
  failing cell prints FAIL and makes it return 1; records written with
  ``--out`` feed ``launch.roofline``'s report.
* ``launch.roofline.hillclimb`` traces each named variant.
* ``fake_world`` refuses to nest and leaves no default group behind.
* ``fake_cuda_guard`` raises, and leaves no stand-in registered, where
  torch does not swap its no-op CUDA guard in.
* The fleet DSE dry-run on the kernel backend traces B1's operator with
  fake CUDA tensors (a torch built without CUDA included), moves fewer
  bytes than the dense backend over the same collectives, and is ok over
  the searches the JAX package's ``backend="pallas"`` record counts; the
  LM cells still refuse ``impl="kernel"``, naming the JAX launcher's plain
  lowering.
"""
from __future__ import annotations

import dataclasses
import json

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ALL_SHAPES, ShapeSpec, get_config
from repro_torch.launch import cells, dryrun, roofline
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models import transformer
from repro_torch.models.common import tree_flatten
from repro_torch.optim import adamw_init

FAMILIES = ("llama3.2-1b", "mamba2-780m", "mixtral-8x7b")
KINDS = ("train", "prefill", "decode")
MESHES = ((1, 1), (2, 2))
S, B = 64, 4
# the JAX record's keys, compile_s -> trace_s (and the device the trace claimed)
RECORD_KEYS = {"cell", "arch", "shape", "mesh", "chips", "device", "ok", "trace_s",
               "scan_corrected", "params", "active_params", "memory", "cost", "collectives",
               "roofline", "op_census_top"}


def _cfg(arch, n_blocks=None):
    cfg = get_config(arch).reduced()
    if n_blocks is not None:
        cfg = dataclasses.replace(cfg, n_layers=cfg.period * n_blocks)
    return cfg


def _dry(cfg, kind, shape=(1, 1)):
    d, m = shape
    with fake_world(d * m, "cpu"):
        mesh = make_mesh((d, m), ("data", "model"), device_type="cpu")
        return dryrun.dryrun_cell(cells.Cell(cfg, ShapeSpec("t", S, B, kind)), mesh,
                                  save=False, device="cpu")


@pytest.fixture(scope="module")
def records():
    out = {}
    for d, m in MESHES:
        with fake_world(d * m, "cpu"):
            mesh = make_mesh((d, m), ("data", "model"), device_type="cpu")
            for arch in FAMILIES:
                for kind in KINDS:
                    out[((d, m), arch, kind)] = dryrun.dryrun_cell(
                        cells.Cell(_cfg(arch), ShapeSpec("t", S, B, kind)), mesh, save=False,
                        device="cpu")
    assert not dist.is_initialized()
    return out


def _real_flops(cfg, kind, on_mesh: bool = False) -> int:
    """FlopCounterMode's total over the step on real tensors: meshless, or
    on a 1x1 mesh in a gloo world of one (where a DTensor's global shapes
    are its local ones, so FlopCounterMode, which counts DTensor's own
    calls, counts what runs)."""
    import contextlib

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed import ctx, sharding
    from repro_torch.launch.mesh import init_world, make_test_mesh

    shape = ShapeSpec("t", S, B, kind)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init(cfg, gen)
    batch = cells.make_inputs(cfg, shape, gen)
    if kind == "train":
        args = (params, adamw_init(params), batch)
    elif kind == "prefill":
        args = (params, batch)
    else:
        args = (params, transformer.init_cache(cfg, B, S), batch)
    with contextlib.ExitStack() as scope:
        mesh = None
        if on_mesh:
            init_world("cpu")
            scope.callback(dist.destroy_process_group)
            mesh = make_test_mesh(1, 1, device_type="cpu")
            scope.enter_context(ctx.use_rules(mesh, sharding.make_rules(mesh)))
        bundle = cells.build_step(cfg, shape, mesh)
        args = cells.distribute_args(bundle, args)
        with FlopCounterMode(display=False) as fc:
            bundle.fn(*args)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILIES)
def test_cell_dry_runs_on_test_meshes(records, arch, kind):
    one, four = records[((1, 1), arch, kind)], records[((2, 2), arch, kind)]
    for rec in (one, four):
        assert set(rec) == RECORD_KEYS and rec["ok"] and rec["scan_corrected"] is False
        assert rec["cost"]["flops_per_device"] > 0 and rec["cost"]["bytes_per_device"] > 0
        assert rec["memory"]["per_device_bytes"] >= rec["memory"]["argument_bytes"] > 0
        assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert (one["chips"], four["chips"]) == (1, 4)
    assert one["cost"]["flops_per_device"] == _real_flops(_cfg(arch), kind, on_mesh=True)
    if kind != "train":
        assert one["cost"]["flops_per_device"] == _real_flops(_cfg(arch), kind)
    assert one["collectives"]["total_bytes"] == 0
    assert four["collectives"]["total_bytes"] > 0
    assert four["memory"]["per_device_bytes"] < one["memory"]["per_device_bytes"]
    if kind != "prefill":  # the step updates its state in place
        assert one["memory"]["alias_bytes"] > 0


# (arch, kind, mesh): the train step at 1x1 (no collectives there; its
# stacked layers' gradients were quadratic), the others' collectives at 2x2
LINEAR = [("llama3.2-1b", "train", (1, 1)), ("mamba2-780m", "prefill", (2, 2)),
          ("mixtral-8x7b", "decode", (2, 2))]


@pytest.mark.parametrize("arch,kind,mesh", LINEAR)
def test_costs_are_linear_in_blocks(arch, kind, mesh):
    f = []
    for nb in (1, 2, 3):
        rec = _dry(_cfg(arch, nb), kind, mesh)
        f.append((rec["cost"]["flops_per_device"], rec["cost"]["bytes_per_device"],
                  rec["collectives"]["total_bytes"]))
    for i in range(3 if mesh != (1, 1) else 2):
        assert f[2][i] - f[1][i] == f[1][i] - f[0][i] > 0, (i, f)


def _reduced_cells(arch=None, shape=None):
    """llama's inference cells at reduced width (the assigned shapes; its
    train cell is held above, and traces slowly on 512 fake ranks)."""
    cfg = _cfg("llama3.2-1b")
    return [cells.Cell(cfg, s) for s in ALL_SHAPES
            if s.kind != "train" and s.name != "long_500k"
            and (shape is None or s.name == shape)]


def test_main_runs_both_meshes_and_writes_records(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(dryrun, "all_cells", _reduced_cells)
    assert dryrun.main(["--arch", "llama3.2-1b", "--mesh", "both", "--device", "cpu",
                        "--no-save"]) == 0
    out = capsys.readouterr().out
    assert out.count(" OK mem/dev=") == 4 and "all 2 cells x 2 meshes OK" in out
    assert not dist.is_initialized()
    assert not list(tmp_path.iterdir())
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--mesh", "single",
                        "--device", "cpu", "--out", str(tmp_path)]) == 0
    recs = roofline.load_records("data=16xmodel=16", tmp_path)
    assert [r["cell"] for r in recs] == ["llama3.2-1b-smoke/decode_32k"]
    saved = json.loads((tmp_path / "data=16xmodel=16" /
                        "llama3.2-1b-smoke__decode_32k.json").read_text())
    assert set(saved) == RECORD_KEYS
    table = roofline.report("data=16xmodel=16", tmp_path)
    assert table.splitlines()[0] == roofline.HEADER.splitlines()[0]
    assert table.splitlines()[2] == roofline.row(saved)
    assert roofline.main(["--report", "--dir", str(tmp_path)]) == 0
    assert "llama3.2-1b-smoke/decode_32k" in capsys.readouterr().out


def test_main_reports_a_failing_cell(monkeypatch, capsys):
    def broken(cell, mesh, **kw):
        raise RuntimeError("no layout")

    monkeypatch.setattr(dryrun, "all_cells", _reduced_cells)
    monkeypatch.setattr(dryrun, "dryrun_cell", broken)
    assert dryrun.main(["--arch", "llama3.2-1b", "--mesh", "single", "--device", "cpu",
                        "--no-save"]) == 1
    assert capsys.readouterr().out.count(" FAIL RuntimeError('no layout')") == 2
    assert not dist.is_initialized()


def test_fake_world_refuses_to_nest():
    with fake_world(4, "cpu"):
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="exists already"):
            with fake_world(2, "cpu"):
                pass
        assert dist.get_world_size() == 4
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with fake_world(2, "cpu"):
            raise ValueError("inside")
    assert not dist.is_initialized()


_GUARD_UNSWAPPED = """
import torch
from repro_torch.launch import dryrun

torch._C._ensureCUDADeviceGuardSet = lambda: None  # a torch whose swap never happens
try:
    dryrun.fake_cuda_guard()
except RuntimeError as e:
    print("raised:", e)
with dryrun.fake_mode("cpu"):
    x = torch.empty(4, 3, device="cuda")
    try:
        x[torch.tensor([0, 1])]
        print("indexed")
    except RuntimeError as e:
        print("index:", e)
print("kept:", len(dryrun._GUARD_STANDIN))
"""


def test_fake_cuda_guard_never_leaves_its_stand_in_registered():
    """Where torch does not swap its no-op CUDA guard in for the stand-in,
    ``fake_cuda_guard`` clears the registry's CUDA slot again and raises,
    so no guard call reaches the stand-in (a fresh process: the guard is
    registered once per process)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", _GUARD_UNSWAPPED], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    if torch.cuda._is_compiled():  # a CUDA build has its own guard: nothing is done
        assert "raised" not in out.stdout and "indexed" in out.stdout
        return
    assert "raised: torch" in out.stdout and "did not replace the stand-in" in out.stdout
    assert "index: PyTorch is not linked with support for cuda devices" in out.stdout
    assert "kept: 0" in out.stdout


def test_kernel_backend_dry_runs_through_the_operator(capsys):
    """(a) The fleet DSE dry-run on the kernel backend: B1's operator traced
    with fake CUDA tensors on this CPU-only host, an OK line, no launch."""
    from repro_torch.kernels.imc_eval.ops import imc_eval_multi

    assert dryrun.main(["--search-mesh", "2x1", "--backend", "kernel", "--device", "cuda",
                        "--no-save"]) == 0
    out = capsys.readouterr().out
    assert "[paper-dse-fleet search=2xdata=1] ok searches=2 backend=kernel" in out
    assert imc_eval_multi.launches == 0
    assert not dist.is_initialized()


def _fleet(backend, searches, pop_size=64):
    from repro_torch.launch.mesh import make_search_mesh

    with fake_world(searches, "cuda"):
        mesh = make_search_mesh(searches, 1, device_type="cuda")
        return dryrun.dryrun_paper_search_batched(mesh, pop_size=pop_size, save=False,
                                                  backend=backend, device="cuda")


def test_kernel_record_against_dense_and_the_jax_pallas_record(monkeypatch):
    """(b) At 2x1 and a population of 64 the kernel record moves fewer bytes
    than the dense one over the same layout (equal collective bytes); it is
    ok and counts the searches the JAX package's ``backend="pallas"`` record
    counts at the same mesh and population (1x1 where JAX sees one device)."""
    import os

    import jax

    # the JAX launcher sets XLA_FLAGS (512 host devices) when first imported:
    # restored after the test, so no later subprocess of this worker sees it
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch.dryrun import dryrun_paper_search_batched as jax_dryrun
    from repro.launch.mesh import make_search_mesh as jax_search_mesh

    kernel, dense = _fleet("kernel", 2), _fleet("dense", 2)
    assert kernel["ok"] and dense["ok"]
    assert kernel["cell"] == "paper-dse-fleet/b2xpop64/kernel"
    assert 0 < kernel["bytes_per_device"] < dense["bytes_per_device"] / 10
    assert kernel["collective_bytes"] == dense["collective_bytes"]
    s = 2 if jax.device_count() >= 2 else 1
    ref = jax_dryrun(jax_search_mesh(s, 1), pop_size=64, save=False, backend="pallas")
    mine = kernel if s == 2 else _fleet("kernel", 1)
    assert (mine["ok"], mine["searches"]) == (ref["ok"], ref["searches"]) == (True, s)
    assert not dist.is_initialized()


def test_lm_cells_refuse_the_kernels():
    """(c) An LM cell traces the plain attention and SSD: the JAX launcher
    lowers attn_impl='jnp' only."""
    with pytest.raises(ValueError, match="JAX launcher lowers attn_impl='jnp' only"):
        dryrun.dryrun_cell(cells.Cell(_cfg("llama3.2-1b"), ShapeSpec("t", S, B, "prefill")),
                           None, save=False, device="cpu", build_kwargs={"impl": "kernel"})
    with pytest.raises(ValueError, match="device must be cuda"):
        dryrun.main(["--search-mesh", "2x1", "--backend", "kernel", "--device", "cpu",
                     "--no-save"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("backend", ["dense", "table"])
def test_paper_search_dry_runs(backend, capsys):
    """The fleet DSE evaluation traces, and leaves no fake tensor in the
    search path's device caches: a real evaluation on the CPU follows."""
    from repro_torch.core import space
    from repro_torch.imc.cost import evaluate_designs_arrays
    from repro_torch.workloads.cnn import cnn_workload
    from repro_torch.workloads.pack import pack_workloads

    assert dryrun.main(["--search-mesh", "2x2", "--backend", backend, "--device", "cpu",
                        "--no-save"]) == 0
    out = capsys.readouterr().out
    assert f"searches=2 backend={backend}" in out and "flops/dev=" in out
    ws = pack_workloads([("alexnet", cnn_workload("alexnet"))])
    r = evaluate_designs_arrays(space.decode(torch.zeros(3, space.N_GENES)), ws.feats, ws.mask)
    assert all(type(t) is torch.Tensor for t in r)
    assert r[0].numpy().shape[0] == 3


def test_meshless_dry_run_counts_the_real_step():
    cfg = _cfg("mamba2-780m")
    rec = dryrun.dryrun_cell(cells.Cell(cfg, ShapeSpec("t", S, B, "decode")), None,
                             save=False, device="cpu")
    assert rec["mesh"] == "meshless" and rec["chips"] == 1
    assert rec["cost"]["flops_per_device"] == _real_flops(cfg, "decode")
    assert rec["memory"]["argument_bytes"] == sum(
        t.numel() * t.element_size()
        for t in tree_flatten(cells.build_step(cfg, ShapeSpec("t", S, B, "decode"),
                                               None).args)[0])


def test_hillclimb_traces_each_variant(monkeypatch, capsys):
    """``launch.roofline.hillclimb`` traces a cell once per named variant on
    the fake single-pod mesh (reduced llama, so a CPU trace is short)."""
    import repro_torch.configs.base as base

    real = base.get_config
    monkeypatch.setattr(base, "get_config", lambda name: real(name).reduced())
    out = roofline.hillclimb("llama3.2-1b/decode_32k", ["baseline", "no-fsdp"], device="cpu")
    assert [v for v, _ in out] == ["baseline", "no-fsdp"]
    assert all(rec["ok"] and rec["mesh"] == "data=16xmodel=16" for _, rec in out)
    assert capsys.readouterr().out.count("[llama3.2-1b/decode_32k :: ") == 2
    assert not dist.is_initialized()


def _same_record(a, b):
    """Two records of one cell, all but the host's trace seconds."""
    assert {k: v for k, v in a.items() if k != "trace_s"} == \
        {k: v for k, v in b.items() if k != "trace_s"}


def test_no_correction_is_a_documented_no_op(records, monkeypatch, capsys):
    """``dryrun_cell(correct=False)`` and ``main([..., "--no-correction"])``
    (the JAX launcher's multi-pod switch) give the record the trace gives
    anyway, ``scan_corrected`` false, in a fake world of 4 ranks."""
    cell = cells.Cell(_cfg("llama3.2-1b"), ShapeSpec("t", S, B, "decode"))
    with fake_world(4, "cpu"):
        mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
        rec = dryrun.dryrun_cell(cell, mesh, save=False, device="cpu", correct=False)
    assert rec["scan_corrected"] is False
    _same_record(rec, records[((2, 2), "llama3.2-1b", "decode")])

    seen = []
    real = dryrun.dryrun_cell

    def spy(*a, **kw):
        seen.append(kw["correct"])
        return real(*a, **kw)

    monkeypatch.setattr(dryrun, "dryrun_cell", spy)
    monkeypatch.setattr(dryrun, "all_cells", lambda arch, shape: [cell])
    monkeypatch.setattr(dryrun, "_meshes", lambda which: [(dryrun.SINGLE, False, 4)])
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda multi_pod, device_type: make_mesh(
        (2, 2), ("data", "model"), device_type=device_type))
    for flags in ([], ["--no-correction"]):
        assert dryrun.main(["--arch", "llama3.2-1b", "--mesh", "single", "--device", "cpu",
                            "--no-save", *flags]) == 0
    assert seen == [True, False]
    assert capsys.readouterr().out.count("] OK mem/dev=") == 2
    assert dryrun.main(["--search-mesh", "2x1", "--backend", "table", "--device", "cpu",
                        "--no-save", "--no-correction"]) == 0
    assert not dist.is_initialized()


def test_roofline_takes_no_correction(monkeypatch, capsys, tmp_path):
    """``launch.roofline``'s ``--no-correction`` reaches ``hillclimb`` and
    ``dryrun_cell`` as ``correct=False``; the report takes it too."""
    import repro_torch.configs.base as base

    real_cfg, real_cell = base.get_config, dryrun.dryrun_cell
    seen = []

    def spy(*a, **kw):
        seen.append(kw["correct"])
        return real_cell(*a, **kw)

    monkeypatch.setattr(base, "get_config", lambda name: real_cfg(name).reduced())
    monkeypatch.setattr(dryrun, "dryrun_cell", spy)
    assert roofline.main(["--hillclimb", "llama3.2-1b/decode_32k", "--variants", "baseline",
                          "--device", "cpu", "--no-correction"]) == 0
    assert seen == [False]
    assert "[llama3.2-1b/decode_32k :: baseline] comp=" in capsys.readouterr().out
    out = roofline.hillclimb("llama3.2-1b/decode_32k", ["baseline"], "cpu",
                             correct=False)
    assert seen == [False, False] and out[0][1]["scan_corrected"] is False
    assert roofline.main(["--report", "--no-correction", "--dir", str(tmp_path)]) == 0
    assert roofline.HEADER.splitlines()[0] in capsys.readouterr().out
    assert not dist.is_initialized()


def test_launchers_describe_themselves_with_doc(capsys):
    for mod in (dryrun, roofline):
        assert mod.DOC == mod.__doc__
        with pytest.raises(SystemExit):
            mod.main(["--help"])
        out = capsys.readouterr().out
        assert "--no-correction" in out and mod.DOC.strip().splitlines()[0] in out
