"""The port's public surface against the JAX package's, from ``ast`` alone
(neither ``jax`` nor ``torch`` is imported).

For every module of ``src/repro/`` (and every script of ``examples/``)
the port has the module of the same relative path under
``src/repro_torch/`` (``kernels/<k>/kernel.py`` -> ``kernels/<k>/ops.py``;
``examples/<x>.py`` -> ``src/repro_torch/examples/<x>.py``), and there:

* every public module-level name of the JAX module: functions, classes,
  assignments (tuple targets too) and the names it re-exports (imports
  from the package itself in an ``__init__.py`` or on a line marked
  ``noqa: F401``; a name from a library outside the package is that
  library's surface).  A port module's ``__all__`` counts as defining its
  names (``repro_torch.core`` loads them on first use).
  A port name imported from the port is audited where it is defined; a
  JAX function or class that the port only imports from a library is a
  gap;
* every public method and class-level field of a JAX class;
* every parameter of a public JAX function or method present in both
  packages, unless the port's takes ``**kw``.

Each difference that stays is a row of ``EXCEPTIONS``: the key names it
(``module``, ``module::name``, ``module::Class.member``,
``module::function(param)``), the row gives the port's counterpart, if
any, and a one-line reason.  A row whose gap is closed is stale and fails,
so the table is the list of what the port does not do as the JAX package
does.
"""
from __future__ import annotations

import ast
from functools import lru_cache
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

PALLAS = "a Pallas knob: the CUDA kernel has no interpret mode; a CPU tensor runs the plain version"
NO_FUSED = "the JAX package's two survival programs give the same bits; the port has one"
KEY = "randomness is a torch.Generator or uniform blocks; threefry keys enter through prng='threefry'"
IMPL = "the port's name for the attention / SSD switch ('kernel' or 'plain')"

# key -> (the port's counterpart or None, why).  A counterpart is a port
# module (``path``), a name in one (``path::name``, ``path::Class.member``)
# or, for a parameter, the port function's parameter that takes its place.
EXCEPTIONS = {
    # ---------------------------------------------------------- analysis
    "analysis/hlo.py": (
        "analysis/census.py",
        "parses XLA's optimized HLO text; the port counts the traced dispatch stream"),
    "analysis/roofline.py::ICI_BW": (
        "analysis/roofline.py::LINK_BW", "the TPU's ICI link rate; the card's NVLink rate per card"),
    "analysis/roofline.py::ICI_LINKS": (
        None, "usable links of a TPU torus axis pair; NVLink's LINK_BW is already per card"),
    "analysis/roofline.py::roofline_terms(hlo_flops)": (
        "flops", "FLOPs counted from a trace, not read from HLO"),
    "analysis/roofline.py::roofline_terms(hlo_bytes)": (
        "bytes_accessed", "bytes counted from a trace, not read from HLO"),
    # -------------------------------------------------------- checkpoint
    "checkpoint/store.py::PyTree": (
        None, "a typing alias for jax pytrees; the port's store types trees as Any"),
    "checkpoint/store.py::save(tree)": (
        "leaves", "save writes flat leaves; store.save_tree(ckpt_dir, step, tree) is the tree form"),
    "checkpoint/store.py::restore(template)": (
        None, "restore returns flat leaves; store.restore_tree(ckpt_dir, template) is the tree form"),
    "checkpoint/store.py::restore_resharded(sharding_tree)": (
        "placements_tree", "DTensor placements in place of NamedShardings"),
    # -------------------------------------------------------------- core
    "core/engine.py::seed_population_batched(keys)": (
        "source", "a torch.Generator per slot or a (B, 2) threefry key tensor"),
    "core/ga.py::default_fused": (None, NO_FUSED),
    "core/ga.py::gen_kernel_enabled": (
        None, "REPRO_GA_KERNEL gates the Pallas step; the port runs B2 on every CUDA table search"),
    "core/ga.py::GAState.key": (
        "core/ga.py::GAState.u", "the state carries the run's whole uniform stream in place of a key"),
    "core/ga.py::run_ga(key)": ("generator", KEY),
    "core/ga.py::run_ga(fused)": (None, NO_FUSED),
    "core/ga.py::run_ga_batched(keys)": ("generators", KEY),
    "core/ga.py::run_ga_batched(fused)": (None, NO_FUSED),
    "core/ga.py::init_ga_state(key)": ("u_blocks", "the state holds the uniform stream itself"),
    "core/ga.py::init_ga_state_batched(keys)": (
        "u_blocks", "the state holds the uniform stream itself"),
    "core/ga.py::run_ga_batched_segment(fused)": (None, NO_FUSED),
    "core/ga.py::run_pareto_batched(keys)": ("generators", KEY),
    "core/ga.py::run_pareto_batched(fused)": (None, NO_FUSED),
    # ------------------------------------------------------- distributed
    "distributed/compression.py::psum_compressed(axis)": (
        "group", "a torch.distributed process group in place of a mesh axis name"),
    "distributed/compression.py::compressed_allreduce(axis)": (
        "group", "a torch.distributed process group in place of a mesh axis name"),
    "distributed/sharding.py::named_sharding_tree(spec_tree)": (
        "specs", "the same tree of specs under the port's name"),
    # ----------------------------------------------------------- kernels
    "kernels/_compat.py": (None, "Pallas's version shim"),
    "kernels/flash_attention/kernel.py::NEG_INF": (
        None, "the mask value is a constant of the CUDA source (csrc/flash_attention.cu)"),
    "kernels/flash_attention/kernel.py::flash_attention_pallas": (
        "kernels/flash_attention/ops.py::flash_attention", "the Pallas entry point"),
    "kernels/flash_attention/ops.py::flash_attention(block_q)": (
        None, "Pallas block size; the CUDA kernel picks its tiles by head dim"),
    "kernels/flash_attention/ops.py::flash_attention(block_k)": (
        None, "Pallas block size; the CUDA kernel picks its tiles by head dim"),
    "kernels/flash_attention/ops.py::flash_attention(interpret)": (None, PALLAS),
    "kernels/ga_gen_step/__init__.py::default_interpret": (None, PALLAS),
    "kernels/ga_gen_step/__init__.py::ga_gen_step_pallas": (
        "kernels/ga_gen_step/ops.py::ga_gen_step", "the Pallas entry point"),
    "kernels/ga_gen_step/__init__.py::make_kernel_gen_step": (
        "core/ga.py::make_gen_step", "the callback's gen_step (the B2 wrapper) is the step"),
    "kernels/ga_gen_step/kernel.py::default_interpret": (None, PALLAS),
    "kernels/ga_gen_step/kernel.py::ga_gen_step_pallas": (
        "kernels/ga_gen_step/ops.py::ga_gen_step", "the Pallas entry point"),
    "kernels/ga_gen_step/ops.py::make_kernel_gen_step": (
        "core/ga.py::make_gen_step", "the callback's gen_step (the B2 wrapper) is the step"),
    "kernels/imc_eval/kernel.py::LANE": (None, "the TPU vector register's 128 lanes"),
    "kernels/imc_eval/kernel.py::SUB": (None, "the TPU vector register's 8 sublanes"),
    "kernels/imc_eval/kernel.py::default_interpret": (None, PALLAS),
    "kernels/imc_eval/kernel.py::imc_eval_pallas_multi": (
        "kernels/imc_eval/ops.py::imc_eval_multi", "the Pallas entry point"),
    "kernels/imc_eval/kernel.py::imc_eval_pallas": (
        "kernels/imc_eval/ops.py::imc_eval_multi", "one wrapper takes one workload or many"),
    "kernels/imc_eval/ops.py::evaluate_designs_kernel_arrays(backend)": (
        None, "the Pallas / jnp switch; the engine's backend='dense' is the plain path"),
    "kernels/imc_eval/ops.py::evaluate_designs_kernel_arrays(interpret)": (None, PALLAS),
    "kernels/imc_eval/ops.py::evaluate_designs_kernel(backend)": (
        None, "the Pallas / jnp switch; the engine's backend='dense' is the plain path"),
    "kernels/imc_eval/ops.py::evaluate_designs_kernel(interpret)": (None, PALLAS),
    "kernels/ssd_scan/kernel.py::ssd_scan_pallas": (
        "kernels/ssd_scan/ops.py::ssd_chunked", "the Pallas entry point"),
    "kernels/ssd_scan/ops.py::ssd_chunked(interpret)": (None, PALLAS),
    # ------------------------------------------------------------ launch
    "launch/cells.py::make_inputs(key)": ("generator", KEY),
    "launch/cells.py::StepBundle.in_shardings": (
        "launch/cells.py::StepBundle.in_placements", "DTensor placements in place of PartitionSpecs"),
    "launch/cells.py::StepBundle.out_shardings": (
        "launch/cells.py::StepBundle.out_placements", "DTensor placements in place of PartitionSpecs"),
    "launch/cells.py::StepBundle.donate_argnums": (
        "launch/cells.py::StepBundle.updates_in_place", "the step updates those arguments in place"),
    "launch/dryrun.py::scan_corrected_costs": (
        None, "XLA counts a while body once; an eager trace counts every layer"),
    "launch/dryrun.py::dryrun_cell(keep_hlo)": ("keep_census", "the census stands in for the HLO"),
    "launch/train.py::build_state(key)": ("seed", KEY),
    # ------------------------------------------------------------ models
    "models/common.py::init_params(key)": ("generator", KEY),
    "models/mamba.py::mamba_mixer(cache)": (None, "the JAX function never reads it"),
    "models/transformer.py::attn_full(attn_impl)": ("impl", IMPL),
    "models/transformer.py::forward(attn_impl)": ("impl", IMPL),
    "models/transformer.py::prefill(attn_impl)": ("impl", IMPL),
    "models/transformer.py::init(key)": ("generator", KEY),
    "serve/steps.py::make_prefill_step(attn_impl)": ("impl", IMPL),
    "train/step.py::loss_fn(attn_impl)": ("impl", IMPL),
    "train/step.py::make_train_step(attn_impl)": ("impl", IMPL),
    # ------------------------------------------------------------- utils
    "utils/unroll.py": (None, "unrolls lax.scan for XLA's cost analysis; an eager trace needs none"),
}


# ---------------------------------------------------------------- the scan
def _is_main_guard(node) -> bool:
    return (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
            and isinstance(node.test.left, ast.Name) and node.test.left.id == "__name__")


def _top(body):
    """Module-level statements, through ``if`` / ``try`` (not the main guard)."""
    for node in body:
        if _is_main_guard(node):
            continue
        if isinstance(node, ast.If):
            yield from _top(node.body)
            yield from _top(node.orelse)
        elif isinstance(node, ast.Try):
            yield from _top(node.body)
            for h in node.handlers:
                yield from _top(h.body)
            yield from _top(node.orelse)
            yield from _top(node.finalbody)
        else:
            yield node


def _targets(t):
    if isinstance(t, ast.Name):
        yield t.id
    elif isinstance(t, (ast.Tuple, ast.List)):
        for e in t.elts:
            yield from _targets(e)


def _from_package(node) -> bool:
    if isinstance(node, ast.ImportFrom):
        mod = node.module or ""
        return node.level > 0 or mod == "repro" or mod.startswith("repro.")
    return any(a.name == "repro" or a.name.startswith("repro.") for a in node.names)


@lru_cache(maxsize=None)
def _names(path: Path, reference: bool) -> dict:
    """Public module-level name -> its defining node (None: only in
    ``__all__``)."""
    return {k: v for k, v in _all_names(path, reference).items() if not k.startswith("_")}


@lru_cache(maxsize=None)
def _all_names(path: Path, reference: bool) -> dict:
    """``_names``, private names included."""
    src = path.read_text()
    lines = src.splitlines()
    out, listed = {}, set()
    for node in _top(ast.parse(src).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in node.targets if isinstance(node, ast.Assign) else [node.target]:
                for n in _targets(t):
                    out[n] = node
                    if n == "__all__" and node.value is not None:
                        listed |= set(ast.literal_eval(node.value))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            if reference and not (_from_package(node) and (
                    path.name == "__init__.py" or "noqa: F401" in lines[node.lineno - 1])):
                continue
            for a in node.names:
                out[(a.asname or a.name).split(".")[0]] = node
    for n in listed:
        out.setdefault(n, None)
    return out


def _imported_file(path: Path, node) -> Path | None:
    """The port's file that ``from ... import`` in ``path`` reads (None:
    outside the port)."""
    if node.level:
        base = path.parents[node.level - 1]
    elif node.module == "repro_torch" or (node.module or "").startswith("repro_torch."):
        base = PORT.parent
    else:
        return None
    p = base.joinpath(*(node.module or "").split(".")) if node.module else base
    for f in (p.with_suffix(".py"), p / "__init__.py"):
        if f.exists():
            return f
    return None


def _defining(path: Path, name: str):
    """The node that defines the port's ``name`` of ``path``, through
    imports from the port itself (an import from elsewhere stays)."""
    node = _all_names(path, False).get(name)
    for _ in range(8):
        if not isinstance(node, ast.ImportFrom):
            break
        f = _imported_file(path, node)
        if f is None:
            break
        name = next(a.name for a in node.names if (a.asname or a.name) == name)
        path, node = f, _all_names(f, False).get(name)
    return node


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if n not in ("self", "cls")], a.kwarg is not None


def _members(cls) -> dict:
    """Public methods (and ``__init__``) and class-level fields."""
    out = {}
    for m in cls.body:
        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not m.name.startswith("_") or m.name == "__init__":
                out[m.name] = m
        elif isinstance(m, ast.AnnAssign) and isinstance(m.target, ast.Name):
            out[m.target.id] = m
        elif isinstance(m, ast.Assign):
            for t in m.targets:
                out.update((n, m) for n in _targets(t))
    return {k: v for k, v in out.items() if not k.startswith("_") or k == "__init__"}


def _is_fn(node) -> bool:
    return isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))


def module_pairs():
    """(key, JAX file, the port's file) for every JAX module and example."""
    for jf in sorted(JAX.rglob("*.py")):
        rel = jf.relative_to(JAX)
        if rel.parts[0] == "kernels" and rel.name == "kernel.py":
            prel = rel.with_name("ops.py")
        else:
            prel = rel
        yield str(rel), jf, PORT / prel
    for jf in sorted((ROOT / "examples").glob("*.py")):
        yield f"examples/{jf.name}", jf, PORT / "examples" / jf.name


@lru_cache(maxsize=None)
def gaps() -> tuple:
    """Every public JAX module, name, member or parameter the port lacks."""
    out = []
    for key, jf, pf in module_pairs():
        if not pf.exists():
            out.append(key)
            continue
        jn, pn = _names(jf, True), _names(pf, False)
        for name, node in jn.items():
            if name not in pn:
                out.append(f"{key}::{name}")
                continue
            other = _defining(pf, name)
            if (_is_fn(node) and not _is_fn(other)) or (
                    isinstance(node, ast.ClassDef) and not isinstance(other, ast.ClassDef)):
                # a JAX def or class the port only imports from a library
                out.append(f"{key}::{name}")
                continue
            fns = []
            if _is_fn(node) and _is_fn(other):
                fns.append((name, node, other))
            if isinstance(node, ast.ClassDef) and isinstance(other, ast.ClassDef):
                jm, pm = _members(node), _members(other)
                for m, mnode in jm.items():
                    if m not in pm:
                        if m != "__init__":
                            out.append(f"{key}::{name}.{m}")
                    elif _is_fn(mnode) and _is_fn(pm[m]):
                        fns.append((f"{name}.{m}", mnode, pm[m]))
            for label, f, g in fns:
                theirs, _ = _params(f)
                ours, takes_kw = _params(g)
                if not takes_kw:
                    out.extend(f"{key}::{label}({p})" for p in theirs if p not in ours)
    return tuple(out)


def _port_file(key: str) -> Path:
    """The port's file of a table key's JAX module."""
    mod = key.split("::")[0]
    return dict((k, pf) for k, _, pf in module_pairs())[mod]


def _port_has(path: str) -> bool:
    """Whether ``path`` / ``path::name`` / ``path::Class.member`` exists in
    the port."""
    mod, _, name = path.partition("::")
    f = PORT / mod
    if not f.exists():
        return False
    if not name:
        return True
    top, _, member = name.partition(".")
    names = _names(f, False)
    if top not in names:
        return False
    return not member or member in _members(names[top])


def _port_function(key: str):
    """The port's function (or method) of a parameter row."""
    name = key.split("::")[1].split("(")[0]
    top, _, member = name.partition(".")
    node = _defining(_port_file(key), top)
    return _members(node)[member] if member else node


# ---------------------------------------------------------------- the tests
def test_imported_names_resolve_to_their_definition():
    """A port name imported from the port is audited where it is defined;
    one imported from a library stays an import (a gap if JAX defines it)."""
    fn = _defining(PORT / "core" / "search.py", "make_eval_fn")
    assert _is_fn(fn) and fn.name == "make_eval_fn" and "backend" in _params(fn)[0]
    assert isinstance(_defining(PORT / "core" / "search.py", "np"), ast.Import)


def test_every_module_pair_is_found():
    pairs = list(module_pairs())
    assert len(pairs) > 60
    assert sum(pf.exists() for _, _, pf in pairs) == len(pairs) - sum(
        "::" not in k for k in EXCEPTIONS)


def test_every_difference_has_a_row():
    """Every public JAX name and parameter is in the port or in the table."""
    missing = [g for g in gaps() if g not in EXCEPTIONS]
    assert not missing, "not in the port and no row in EXCEPTIONS:\n" + "\n".join(missing)


@pytest.mark.parametrize("key", sorted(EXCEPTIONS))
def test_row_is_not_stale(key):
    """The row names something of the JAX package that the port still
    lacks; its counterpart exists; its reason is one line."""
    counterpart, why = EXCEPTIONS[key]
    assert why and "\n" not in why and len(why) <= 110, why
    assert key in gaps(), f"{key}: the port has it now (or the JAX package does not): drop the row"
    if counterpart is None:
        return
    if key.endswith(")"):
        ours, _ = _params(_port_function(key))
        assert counterpart in ours, f"{key}: the port's function has no {counterpart!r}"
    else:
        assert _port_has(counterpart), f"{key}: {counterpart} is not in the port"


@pytest.mark.parametrize("name", [
    "imc/tables.py::table_bytes",
    "imc/tables.py::grid_table_shape",
    "core/engine.py::make_eval_fn",
    "core/search.py::make_eval_fn",
    "core/search.py::EngineFault",
    "core/search.py::NonFiniteScoreError",
    "core/search.py::empty_partial_result",
    "core/objectives.py::INF",
    "kernels/imc_eval/ops.py::evaluate_designs_kernel",
    "analysis/roofline.py::Roofline.table_row",
    "models/transformer.py::template_structs",
    "models/common.py::layer_norm",
    "launch/dryrun.py::DOC",
    "launch/roofline.py::DOC",
    "examples/serve_demo.py::main",
])
def test_named_gap_is_closed(name):
    """The names the JAX package's callers reach that the port once lacked."""
    assert _port_has(name)


@pytest.mark.parametrize("key", [
    "core/search.py::run_search(fused)",
    "core/search.py::run_search(pipelined)",
    "core/search.py::batched_search(fused)",
    "core/search.py::batched_search(pipelined)",
    "launch/dryrun.py::dryrun_cell(correct)",
    "launch/roofline.py::hillclimb(correct)",
])
def test_named_parameter_is_closed(key):
    ours, _ = _params(_port_function(key))
    assert key.split("(")[1][:-1] in ours
