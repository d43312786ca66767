"""Build and load the port's CUDA kernels and their PyTorch operators.

Each kernel is one shared library, built at first use from two of the
repo's sources into ``build/repro_torch_kernels/`` at the root of the
checkout (override with ``REPRO_TORCH_BUILD_DIR``), under a name keyed by
a hash of its sources, its flags and torch's version, so an edited source
is rebuilt and an unchanged one is reused:

* the kernel, ``csrc/<name>.cu``, with a plain ``extern "C"`` interface:
  a launcher that enqueues its kernel on the given stream and returns
  ``cudaGetLastError()``, ``<name>_error_string`` for the message, and
  the queries its wrapper asks (lanes, shared memory);
* the operator, ``csrc/<name>_op.cpp`` (with ``csrc/torch_op.h``): the
  CUDA implementation of ``repro_torch::<name>``, which calls that
  launcher, registered with PyTorch's dispatcher when the library is
  loaded; compiled by nvcc's host compiler against the running torch's
  headers and libraries (its C++ ABI).

One nvcc takes both sources:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas=-v <name>.cu <name>_op.cpp <torch>

``-fmad=false`` (device code only) keeps ``a*b + c`` as two rounded
operations, as PyTorch's separate elementwise kernels compute it; nothing
is built with ``--use_fast_math``, so divisions and square roots stay
IEEE; a kernel that wants fused multiply-adds writes ``fmaf`` explicitly.
``build()`` starts one nvcc per missing library, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("imc_eval", "ga_gen_step", "flash_attention", "ssd_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
OP_HEADER = "torch_op.h"

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                       "kernels are built on a host with the CUDA toolkit")


def torch_flags() -> List[str]:
    """Compiler and linker flags of the running torch: its C++ ABI, its
    headers, the libraries an operator calls into (the dispatcher and
    ATen, c10, c10's CUDA streams), found again at load time by rpath."""
    import torch

    root = Path(torch.__file__).resolve().parent
    lib = root / "lib"
    return [f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            "-I", str(root / "include"),
            "-I", str(root / "include" / "torch" / "csrc" / "api" / "include"),
            "-L", str(lib), "-lc10", "-lc10_cuda", "-ltorch_cpu",
            "-Xlinker", f"-rpath={lib}"]


def _sources(name: str) -> List[Path]:
    return [CSRC / f"{name}.cu", CSRC / f"{name}_op.cpp"]


def lib_path(name: str) -> Path:
    """The library of ``name`` (for the running torch)."""
    import torch

    parts = [src.read_bytes() for src in (*_sources(name), CSRC / OP_HEADER)]
    parts.append("\0".join((*NVCC_FLAGS, *torch_flags(), torch.__version__)).encode())
    h = hashlib.sha256(b"\0".join(parts)).hexdigest()[:16]
    return build_dir() / f"lib{name}_{h}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library in parallel (one nvcc each).  Returns
    seconds per kernel actually built; raises with nvcc's output if any
    build fails.  The compiler's log (registers, shared memory, spills)
    is kept beside each library as ``<lib>.log``."""
    names = list(KERNELS if names is None else names)
    todo = [n for n in names if not lib_path(n).exists()]
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    exe, flags = nvcc(), torch_flags()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        target = lib_path(n)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources(n)), *flags]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, target)
    secs, failed = {}, []
    for n, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    p = lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name`` (its queries), building it first if
    needed; loading it registers ``repro_torch::<name>``'s CUDA
    implementation."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
