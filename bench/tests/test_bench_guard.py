"""No process the benchmark starts holds JAX or the JAX package, compared by
top-level module name (``repro_torch`` is not ``repro``)."""
import subprocess
import sys

from bench.harness.spec import ROOT
from bench.run import forbidden_modules

PROBE = f"""
import sys, time
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
import bench.reference.model, bench.reference.grid, bench.readings, bench.run
from bench.harness.cell import run_cell
run_cell("lm3-sweep-table", 11, 0.5, False, t_start=time.perf_counter(), device="cpu")
print(sorted({{m.split('.')[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "repro"}}))
print("repro_torch" in sys.modules)
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "True"]


def test_the_guard_compares_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert {"repro", "jaxlib"} <= set(forbidden_modules())


def test_run_refuses_without_a_card():
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal needs a machine without one")
    out = subprocess.run([sys.executable, str(ROOT / "bench/run.py"), "--workload",
                          "cnn4-serve-table", "--seed", str(2 ** 31 + 5), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
