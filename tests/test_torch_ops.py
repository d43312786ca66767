"""The four kernels as ``repro_torch`` operators, on the CPU.

No card and no compiler here: each operator is traced with fake CUDA
tensors (``launch.dryrun.fake_mode``, which also lets fake CUDA tensors
through a torch built without CUDA) at small shapes (``CASES``:
the joint search's B1 / B2 calls at B=2, P=8, W=2, L=16; reduced llama
and mamba2 heads for B3 and B4, B3 also at D=256, at D=36, which the
CUDA implementation pads for TMA, and at a GQA ratio of 6, which does not
divide 128).  For each:

* through its wrapper and called directly, the fake implementation gives
  the outputs' shapes and dtypes that the wrapper's plain version gives
  on CPU tensors of the same shapes, on the CUDA device, contiguous;
* a malformed input raises the wrapper's error, word for word, through
  the wrapper and from the operator itself;
* a CPU tensor handed to the operator raises: there is no CPU
  implementation (a fake CPU tensor raises as the dispatcher would);
* the wrapper on CPU tensors runs the plain version, and no ``.launches``
  counter moves, there or under the fake mode.

The cases (``CASES``: a wrapper call's arguments as CPU tensors from a
seed; ``op_args``: the operator's; ``MALFORMED``: calls each wrapper
refuses, with the wrapper's message word for word) also serve
``tests/test_torch_gpu.py``, which holds the operators on the card.
"""
from __future__ import annotations

import re

import pytest
import torch

from repro_torch.core import space
from repro_torch.core.ga import SBX_PROB, block_layout
from repro_torch.imc.tables import build_tables_arrays
from repro_torch.imc.tech import TECH
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.ga_gen_step import ops as gops
from repro_torch.kernels.ga_gen_step.ref import table_scores
from repro_torch.kernels.imc_eval import ops as iops
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.launch.dryrun import _device_caches_kept, fake_mode


WRAPPERS = {"imc_eval": iops.imc_eval_multi, "ga_gen_step": gops.ga_gen_step,
            "flash_attention": fops.flash_attention, "ssd_scan": sops.ssd_chunked}
OPS = {"imc_eval": iops.IMC_EVAL, "ga_gen_step": gops.GA_GEN_STEP,
       "flash_attention": fops.FLASH_ATTENTION, "ssd_scan": sops.SSD_SCAN}


def _layers(g, B, W, L):
    """Integer-valued layer features (B, W, L, 6) and ragged masks."""
    feats = torch.round(torch.rand((B, W, L, 6), generator=g) * 100 + 1)
    n = torch.randint(1, L + 1, (B, W), generator=g)
    n[..., 0] = L
    return feats, torch.arange(L) < n[..., None]


def imc_eval(B=2, P=8, W=2, L=16, seed=0):
    """The joint search's B1 call, cut to B=2, P=8, W=2, L=16."""
    g = torch.Generator().manual_seed(seed)
    designs = torch.stack(list(space.decode(torch.rand((B, P, space.N_GENES), generator=g))),
                          dim=-1)
    feats, mask = _layers(g, B, W, L)
    return (designs, feats, mask), {}


def ga_gen_step(B=2, P=8, W=2, L=16, seed=0):
    """The joint search's B2 call, cut to B=2, P=8, W=2, L=16."""
    g = torch.Generator().manual_seed(seed)
    feats, mask = _layers(g, B, W, L)
    tables = build_tables_arrays(feats, mask)
    kind = torch.arange(B) % 4
    area = torch.full((B,), 150.0)
    pop = torch.rand((B, P, space.N_GENES), generator=g)
    scores = table_scores(pop, tables, kind, area)
    u = torch.rand((B, block_layout(P, space.N_GENES).tot), generator=g)
    return (pop, scores, u, (tables, kind, area)), {}


def flash_attention(B=1, Sq=32, Skv=32, H=4, KV=2, D=16, dtype=torch.bfloat16, causal=True,
                    window=0, q_offset=0, seed=0):
    """One attention call; the defaults are reduced llama3.2-1b's heads."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, D)))
    return (q, k, v), dict(causal=causal, window=window, q_offset=q_offset)


def ssd_scan(B=1, S=64, H=8, P=16, N=16, dtype=torch.float32, h0=False, chunk=32, seed=0):
    """One scan call; the defaults are reduced mamba2-780m's heads."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, S, H, P), generator=g).to(dtype)
    dt = torch.rand((B, S, H), generator=g) * 0.1 + 0.01
    A = -torch.rand((H,), generator=g) - 0.1
    Bm = torch.randn((B, S, 1, N), generator=g).to(dtype)
    Cm = torch.randn((B, S, 1, N), generator=g).to(dtype)
    state = torch.randn((B, H, N, P), generator=g) if h0 else None
    return (x, dt, A, Bm, Cm, state), dict(chunk=chunk)


CASES = {
    "imc_eval/joint": lambda: imc_eval(),
    "ga_gen_step/joint": lambda: ga_gen_step(),
    "flash_attention/llama": lambda: flash_attention(),
    "flash_attention/llama_f32": lambda: flash_attention(dtype=torch.float32),
    "flash_attention/d256": lambda: flash_attention(H=2, KV=2, D=256, Sq=16, Skv=16),
    "flash_attention/d36": lambda: flash_attention(H=2, KV=1, D=36, Sq=24, Skv=24),
    "flash_attention/gqa6": lambda: flash_attention(H=12, KV=2, Sq=24, Skv=40, q_offset=16),
    "flash_attention/noncausal": lambda: flash_attention(Sq=24, Skv=40, causal=False),
    "ssd_scan/mamba": lambda: ssd_scan(),
    "ssd_scan/mamba_bf16": lambda: ssd_scan(dtype=torch.bfloat16),
    "ssd_scan/mamba_h0": lambda: ssd_scan(B=2, h0=True),
}


def kernel(case: str) -> str:
    return case.split("/")[0]


def op_args(name: str, args, kwargs) -> tuple:
    """The operator's arguments for the wrapper call ``args, kwargs``."""
    if name == "imc_eval":
        return (*args, iops.consts(TECH))
    if name == "ga_gen_step":
        pop, scores, u, (tables, kind, area) = args
        return (pop, scores, u, *tables, kind, area, *gops._grid_args(TECH, pop.device),
                gops.consts(TECH, SBX_PROB, space.N_GENES))
    if name == "flash_attention":
        return (*args, kwargs["causal"], kwargs["window"], kwargs["q_offset"])
    return (*args, kwargs["chunk"])


def to(tree, device):
    """Every tensor of a wrapper call's arguments on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        vals = [to(t, device) for t in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    if isinstance(tree, dict):
        return {k: to(v, device) for k, v in tree.items()}
    return tree


def _with_table(args, field, leaf):
    pop, scores, u, (tables, kind, area) = args
    return (pop, scores, u, (tables._replace(**{field: leaf}), kind, area))


# name -> (kernel, (args, kwargs) -> malformed (args, kwargs), the wrapper's message)
MALFORMED = {
    "imc_eval/feats": ("imc_eval", lambda a, k: ((a[0], a[1][..., :5], a[2]), k),
                       "feats must be (B, W, L, 6), got (2, 2, 16, 5)"),
    "imc_eval/mask": ("imc_eval", lambda a, k: ((a[0], a[1], a[2][..., :15]), k),
                      "mask must be (2, 2, 16), got (2, 2, 15)"),
    "imc_eval/designs": ("imc_eval", lambda a, k: ((a[0][..., :8], a[1], a[2]), k),
                         "designs must be (B, P, 9), got (2, 8, 8)"),
    "ga_gen_step/scores": ("ga_gen_step", lambda a, k: ((a[0], a[1][:, :7], *a[2:]), k),
                           "scores (2, 7) / u (2, {tot}) do not match (B, P) = (2, 8), "
                           "tot = {tot}"),
    "ga_gen_step/table": ("ga_gen_step",
                          lambda a, k: (_with_table(a, "sum_m", a[3][0].sum_m[:, :1]), k),
                          "table sum_m: (2, 1) on cuda:0, expected leading (2, 2) on cuda:0"),
    "ga_gen_step/pop": ("ga_gen_step", lambda a, k: ((a[0][..., :8], *a[1:]), k),
                        "pop must be (B, P, 9), got (2, 8, 8)"),
    "flash_attention/v": ("flash_attention", lambda a, k: ((a[0], a[1], a[2][..., :8]), k),
                          "k, v must be (B, Skv, KV, D) = (1, 32, 2, 16), got (1, 32, 2, 16) / "
                          "(1, 32, 2, 8)"),
    "flash_attention/gqa": ("flash_attention",
                            lambda a, k: ((a[0][:, :, :3], a[1], a[2]), k),
                            "H=3 must be a multiple of KV=2"),
    "flash_attention/head_dim": ("flash_attention", lambda a, k: (tuple(
        torch.cat([t] * 17, dim=-1)[..., :264] for t in a), k),
        "head dim 264 outside 1..256 (the kernel's largest tier; the largest config "
        "head_dim is 256)"),
    "flash_attention/dtype": ("flash_attention",
                              lambda a, k: ((a[0], a[1].float(), a[2]), k),
                              "q, k, v must share float32 or bfloat16, got torch.bfloat16, "
                              "torch.float32, torch.bfloat16"),
    "flash_attention/q_offset": ("flash_attention", lambda a, k: (a, {**k, "q_offset": -1}),
                                 "q_offset must be >= 0, got -1"),
    "ssd_scan/groups": ("ssd_scan", lambda a, k: ((*a[:3], torch.cat([a[3]] * 2, dim=2),
                                                   torch.cat([a[4]] * 2, dim=2), a[5]), k),
                        "the ssd_scan kernel is written for one B/C group (G=1)"),
    "ssd_scan/dt": ("ssd_scan", lambda a, k: ((a[0], a[1][..., :7], *a[2:]), k),
                    "dt must be (1, 64, 8) and A (8,), got (1, 64, 7) / (8,)"),
    "ssd_scan/chunk": ("ssd_scan", lambda a, k: (a, {**k, "chunk": 48}),
                       "chunk 48 must divide S=64 and be at most 128"),
    "ssd_scan/h0": ("ssd_scan", lambda a, k: ((*a[:5], torch.zeros(1, 8, 16, 8)), k),
                    "h0 must be (1, 8, 16, 16), got (1, 8, 16, 8)"),
    "ssd_scan/dtype": ("ssd_scan", lambda a, k: ((*a[:3], a[3].bfloat16(), a[4], a[5]), k),
                       "x, Bm, Cm must share float32 or bfloat16, got torch.float32, "
                       "torch.bfloat16, torch.float32"),
}


def malformed(case: str):
    """(kernel, CPU args, kwargs, the message as a regex) of a MALFORMED case."""
    name, bend, msg = MALFORMED[case]
    args, kwargs = CASES[{"imc_eval": "imc_eval/joint", "ga_gen_step": "ga_gen_step/joint",
                          "flash_attention": "flash_attention/llama",
                          "ssd_scan": "ssd_scan/mamba"}[name]]()
    args, kwargs = bend(args, kwargs)
    tot = block_layout(8, space.N_GENES).tot
    return name, args, kwargs, "^" + re.escape(msg.format(tot=tot)) + "$"


def _leaves(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _launches():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


@pytest.fixture(autouse=True)
def no_launches():
    before = _launches()
    assert all(v == 0 for v in before.values()), before
    yield
    assert _launches() == before


@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_matches_the_plain_version(case):
    name = kernel(case)
    args, kwargs = CASES[case]()
    plain = _leaves(WRAPPERS[name](*args, **kwargs))
    with _device_caches_kept(), fake_mode():
        fargs, fkw = to(args, "cuda"), to(kwargs, "cuda")
        through = _leaves(WRAPPERS[name](*fargs, **fkw))
        direct = _leaves(OPS[name](*op_args(name, fargs, fkw)))
    assert all(g.is_contiguous() for g in direct)
    if name == "imc_eval":  # the operator's (3, B, W, P), the wrapper's three sums
        direct = list(direct[0].unbind(0))
    assert len(through) == len(direct) == len(plain)
    for got in (through, direct):
        for g, p in zip(got, plain):
            assert (tuple(g.shape), g.dtype) == (tuple(p.shape), p.dtype)
            assert g.device == torch.device("cuda", 0) and type(g).__name__ == "FakeTensor"


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_inputs_raise_the_wrappers_error(case):
    name, args, kwargs, msg = malformed(case)
    with _device_caches_kept(), fake_mode():
        fargs, fkw = to(args, "cuda"), to(kwargs, "cuda")
        with pytest.raises(ValueError, match=msg):
            WRAPPERS[name](*fargs, **fkw)
        with pytest.raises(ValueError, match=msg):
            OPS[name](*op_args(name, fargs, fkw))


@pytest.mark.parametrize("fake", [False, True], ids=["real", "fake"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_operators_have_no_cpu_implementation(name, fake):
    case = next(c for c in sorted(CASES) if kernel(c) == name)
    args, kwargs = CASES[case]()
    with _device_caches_kept():
        call = op_args(name, args, kwargs)
        if not fake:
            with pytest.raises(NotImplementedError, match="CPU"):
                OPS[name](*call)
            return
        with fake_mode():
            with pytest.raises(NotImplementedError, match="CUDA implementation only"):
                OPS[name](*call)


@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_runs_the_plain_version_on_cpu(case):
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.kernels.ga_gen_step.ref import ga_gen_step_ref
    from repro_torch.kernels.imc_eval.ref import eval_workloads
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked

    name = kernel(case)
    args, kwargs = CASES[case]()
    got = _leaves(WRAPPERS[name](*args, **kwargs))
    if name == "imc_eval":
        want = eval_workloads(*args)
    elif name == "ga_gen_step":
        pop, scores, u, (tables, kind, area) = args
        want = ga_gen_step_ref(pop, scores, u, tables, kind, area)
    elif name == "flash_attention":
        want = attention_reference(*args, **kwargs)
    else:
        want = ssd_chunked(*args, **kwargs)
    for g, w in zip(got, _leaves(want), strict=True):
        assert g.device.type == "cpu" and torch.equal(g, w)
