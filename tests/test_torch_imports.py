"""The port stands alone: nothing under ``src/repro_torch/`` and nothing
in ``chip_smoke.py`` imports JAX or the JAX package ``repro``."""
from __future__ import annotations

import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    p for p in (ROOT / "src" / "repro_torch").rglob("*")
    if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".cpp", ".h")
) + [ROOT / "chip_smoke.py"]

_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_REPRO = re.compile(r"^\s*(import\s+repro\b(?!_)|from\s+repro(\.|\s+import)\b)", re.M)


def test_port_files_found():
    assert len(PORT_FILES) > 20


def test_training_modules_are_held():
    """The training path's modules are among the files held below."""
    held = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES[:-1]}
    assert {"optim/__init__.py", "optim/adamw.py", "data/__init__.py", "data/pipeline.py",
            "train/__init__.py", "train/step.py", "launch/train.py",
            "examples/train_lm.py"} <= held


def test_mesh_cell_modules_are_held():
    """The cells, the dry-run, the roofline and the census are among the
    files held below."""
    held = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in PORT_FILES[:-1]}
    assert {"analysis/__init__.py", "analysis/census.py", "analysis/roofline.py",
            "launch/cells.py", "launch/dryrun.py", "launch/roofline.py"} <= held


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    text = path.read_text()
    assert not _JAX.search(text), f"{path} imports jax"
    assert "import jax" not in text
    assert not _REPRO.search(text), f"{path} imports the JAX package"
    assert "repro." not in text.replace("repro_torch", ""), \
        f"{path} names a module of the JAX package"


def test_port_imports_without_jax(tmp_path):
    """A fresh interpreter imports every port module with ``jax`` and
    ``repro`` made unimportable."""
    import subprocess
    import sys

    mods = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in mods]
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'jax' or name.startswith('jax.') or name == 'repro' "
        "or name.startswith('repro.'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
