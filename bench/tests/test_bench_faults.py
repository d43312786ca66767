"""The check against the program broken underneath, and against the
bfloat16 control: a whole run (all but the look for a card) on the CPU, at
the cells' GA sizes with fewer clients and seeds, must come out not
correct.  On the card the same control runs at each cell's own size
(``test_control_on_the_card``; the readings come from ``bench/readings.py``)."""
import json
import shutil
import time

import pytest

from bench.harness import check, faults
from bench.harness.cell import run_cell
from bench.harness.spec import ROOT, Spec

SMALL = {"serve-table": {"clients": 32, "max_slots": 16, "ramp_s": 0.2},
         "sweep-table": {"seeds_per_call": 2}, "sweep-kernel": {"seeds_per_call": 2}}


@pytest.fixture(scope="module")
def small_spec(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "bench", root / "bench")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, change in SMALL.items():
        p = root / "bench/traffic" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **change}))
    return Spec(root)


def _run(spec, cell, seed, seconds, control=False):
    return run_cell(cell, seed, seconds, False, t_start=time.perf_counter(), device="cpu",
                    spec=spec, control=control)


def _breached(out):
    return {k for k, v in out["checks"].items() if not v["value"] <= v["limit"]}


@pytest.mark.parametrize("cell, seconds", [("lm3-sweep-table", 2.0), ("cnn4-serve-table", 2.0)])
def test_sound_run_is_correct_and_the_control_is_not(small_spec, cell, seconds):
    out = _run(small_spec, cell, 2 ** 31 + 101, seconds, control=True)
    assert out["correct"], out["checks"]
    limits = small_spec.limits(cell)
    assert out["control"]["score_gap"] > limits["score_gap"]
    assert not check.verdict({**out["control"], "answers": 1}, limits)


@pytest.mark.parametrize("cell, fault, breaches", [
    ("lm3-sweep-table", "frozen_step", {"rank_share_p50"}),
    ("lm3-sweep-table", "half_batch", {"bad_answers"}),
    ("lm3-sweep-table", "altered_answer", {"score_gap"}),
    ("lm3-sweep-table", "half_joint_frozen", {"stalled_share"}),
    ("lm3-sweep-table", "half_joint_copied", {"bad_answers"}),
    ("cnn4-sweep-kernel", "half_joint_frozen", {"stalled_share"}),
    ("cnn4-sweep-kernel", "half_joint_copied", {"bad_answers"}),
    ("cnn4-serve-table", "frozen_step", {"rank_share_p50"}),
    ("cnn4-serve-table", "half_batch", {"bad_answers"}),
    ("cnn4-serve-table", "half_frozen", {"stalled_share"}),
])
def test_faults_come_out_not_correct(small_spec, cell, fault, breaches):
    with faults.FAULTS[fault]():
        out = _run(small_spec, cell, 2 ** 31 + 202, 2.0)
    assert not out["correct"]
    assert breaches <= _breached(out), out["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["cnn4-serve-table", "cnn4-sweep-kernel", "lm3-sweep-table"])
def test_control_on_the_card(cell):
    """The bfloat16 control at the cell's own size on three seeds: each
    fails the score gap's limit; the program's own answers pass."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = Spec()
    for seed in (2 ** 31 + 301, 2 ** 31 + 302, 2 ** 31 + 303):
        out = run_cell(cell, seed, 5.0, False, t_start=time.perf_counter(), device="cuda:0",
                       spec=spec, control=True)
        assert out["correct"], out["checks"]
        assert out["control"]["score_gap"] > spec.limits(cell)["score_gap"]
