"""Cells on several cards (``bench/harness/ranks.py``): whole runs of the
mesh cell on the CPU, a gloo world of two ranks (a 2x1 search mesh, the
mix's other sizes cut as ``test_bench_faults.py`` cuts the one-card
mix's), each rank its own process as ``bench/run.py`` starts them.  On four
cards (``-m gpu``): ``bench/run.py`` itself, a follower killed mid-window
included."""
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

from bench.harness import check
from bench.harness.spec import ROOT, Spec

CELL = "cnn4-serve-table-4chip"
SMALL = {"clients": 32, "engine": {"max_slots": 16, "pipelined": True},
         "mesh": {"search": 2, "data": 1}, "ramp_s": 0.2, "trace_s": 0.5}
SEED = 2 ** 31 + 4001
RUN_S = 90  # a whole run's limit here; each takes about 20 s

PRELUDE = """
import json, os, sys, time
T_START = time.perf_counter()
sys.path[:0] = [{src!r}, {repo!r}]
from bench.harness import ranks
from bench.harness.spec import Spec
spec = Spec({root!r})
"""

LEAD = PRELUDE + """
lead = ranks.Lead(2, [sys.executable, "-c", {follower!r}])
rc, out = ranks.run_lead(lead, {cell!r}, {seed}, {seconds}, {trace}, spec=spec,
                         t_start=T_START, device_type="cpu", fault={fault!r},
                         control={control})
if out is not None:
    print(json.dumps(out), flush=True)
sys.stderr.flush()
os._exit(rc)
"""

FOLLOWER = PRELUDE + """
{patch}
rc = ranks.follow({cell!r}, {seed}, {trace}, spec, device_type="cpu")
sys.stdout.flush(); sys.stderr.flush()
os._exit(rc)
"""

# the follower's card as the store hands it back: a CPU run traces no card
FAKE_CARD = """
from bench.harness import trace as tracing
ranks._peak = lambda dev: 12345
tracing.summarize = lambda events, clip=False: tracing.Trace(
    window_s=2.0, busy_s=0.5, device_ops=[], idle_gaps=[], launches=[], collective_s=0.25)
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The benchmark with the mesh cell cut to two ranks and a few clients."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "bench", root / "bench")
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in data["workloads"]:
        if w["name"] == CELL:
            w["chips"] = 2
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    p = root / "bench/traffic/serve-table-mesh.json"
    p.write_text(json.dumps({**json.loads(p.read_text()), **SMALL}))
    return root


def _start(root, out_dir, *, seconds=2.0, trace=False, fault="", control=False, patch=""):
    """A lead of two ranks on the CPU, in its own process; its standard
    output and error go to files in ``out_dir``."""
    kw = dict(src=str(ROOT / "src"), repo=str(ROOT), root=str(root), cell=CELL, seed=SEED,
              trace=trace)
    follower = FOLLOWER.format(patch=patch, **kw)
    code = LEAD.format(follower=follower, seconds=seconds, fault=fault, control=control, **kw)
    out, err = open(out_dir / "out", "w"), open(out_dir / "err", "w")
    with out, err:
        return subprocess.Popen([sys.executable, "-c", code], stdout=out, stderr=err,
                                cwd=ROOT)


def _run(root, out_dir, **kw):
    p = _start(root, out_dir, **kw)
    try:
        rc = p.wait(RUN_S)
    finally:
        p.kill()
    return rc, (out_dir / "out").read_text(), (out_dir / "err").read_text()


def _follower_pids(err: str):
    return [int(line.split("(pid ")[1].split(")")[0]) for line in err.splitlines()
            if line.startswith("bench: rank ") and "(pid " in line]


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"  # a zombie is ended
    except FileNotFoundError:
        return True


def test_the_lead_starts_and_reaps_its_follower_and_alone_prints(root, tmp_path):
    rc, out, err = _run(root, tmp_path, control=True)
    assert rc == 0, err[-3000:]
    lines = out.splitlines()
    assert len(lines) == 1, out  # the follower's output went to standard error
    res = json.loads(lines[0])
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 2 and res["attempted"] > 0
    assert set(res["metrics"]) == {"searches_per_s", "setup_s"}
    limits = Spec(root).limits(CELL)
    assert not check.verdict({**res["control"], "answers": 1}, limits)
    (pid,) = _follower_pids(err)
    assert _gone(pid)


def test_the_store_hands_back_a_followers_peak_and_trace(root, tmp_path):
    rc, out, err = _run(root, tmp_path, trace=True, patch=FAKE_CARD)
    assert rc == 0, err[-3000:]
    res = json.loads(out.splitlines()[-1])
    assert res["device"]["memory_peak_bytes"] == 12345
    assert res["metrics"]["follower_idle_share.mesh"]["value"] == pytest.approx(75.0)
    # the lead's CPU run traces no card: the follower's is the only one
    assert res["metrics"]["collective_wait_share.mesh"]["value"] == pytest.approx(12.5)
    assert res["metrics"]["collective_calls_per_launch.mesh"]["value"] > 0
    assert res["metrics"]["collective_bytes_per_search.mesh"]["value"] > 0


@pytest.mark.parametrize("fault, breaches", [
    ("frozen_step", {"stalled_share"}),
    ("half_frozen", {"stalled_share"}),
    ("half_batch", {"bad_answers"}),
    ("altered_answer", {"score_gap"}),
    ("exchange_dropped", {"bad_answers"}),
])
def test_a_fault_reaches_every_rank_and_comes_out_not_correct(root, tmp_path, fault, breaches):
    rc, out, err = _run(root, tmp_path, fault=fault)
    assert rc == 0, err[-3000:]
    assert f"fault {fault}" in err  # planted on the follower too
    res = json.loads(out.splitlines()[-1])
    assert not res["correct"]
    assert breaches <= {k for k, v in res["checks"].items() if not v["value"] <= v["limit"]}
    if fault == "frozen_step":  # every rank's rows froze: no search moved
        assert res["checks"]["stalled_share"]["value"] == 1.0


def test_a_killed_follower_ends_the_run(root, tmp_path):
    p = _start(root, tmp_path, seconds=60.0)
    try:
        deadline = time.monotonic() + RUN_S
        pids = []
        while not pids and time.monotonic() < deadline and p.poll() is None:
            time.sleep(0.2)
            pids = _follower_pids((tmp_path / "err").read_text())
        assert pids, (tmp_path / "err").read_text()[-3000:]
        time.sleep(3.0)  # into the window
        os.kill(pids[0], signal.SIGKILL)
        t = time.monotonic()
        rc = p.wait(30)
        assert time.monotonic() - t < 30
    finally:
        p.kill()
    assert rc != 0
    assert (tmp_path / "out").read_text() == ""
    assert _gone(pids[0])


def test_readings_plant_a_fault_on_every_rank_of_a_reading(root, tmp_path):
    """``bench/readings.py`` on the mesh cell: each reading runs as ranks of
    its own, the fault planted on every one."""
    cmd = [sys.executable, str(root / "bench/readings.py"), "--workload", CELL, "--seeds",
           str(SEED), "--seconds", "1", "--control-seeds", "0", "--faults",
           "exchange_dropped", "--fault-seeds", "1", "--device", "cpu"]
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                       cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                       timeout=2 * RUN_S)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "fault exchange_dropped" in p.stderr  # the follower's, on its standard error
    program, dropped, summary = (json.loads(x) for x in p.stdout.splitlines())
    limits = Spec(root).limits(CELL)
    assert program["mode"] == "program" and check.verdict({**program, "answers": 1}, limits)
    assert dropped["mode"] == "exchange_dropped" and dropped["bad_answers"] > 0
    assert summary["summary"]["exchange_dropped"]["bad_answers"] == dropped["bad_answers"]


@pytest.mark.gpu
def test_the_cell_on_four_cards_and_a_killed_follower(tmp_path):
    """``bench/run.py`` on the mesh cell: a short run is correct on four
    cards, and a follower killed mid-window ends the run within 30 s with
    no rank left."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    cmd = [sys.executable, str(ROOT / "bench/run.py"), "--workload", CELL, "--seed",
           str(SEED), "--trace", "0"]
    out = subprocess.run(cmd + ["--seconds", "5"], stdout=subprocess.PIPE, text=True,
                         timeout=600)
    assert out.returncode == 0
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["count"] == 4, res

    err = tmp_path / "err"
    with open(err, "w") as f:
        p = subprocess.Popen(cmd + ["--seconds", "60"], stdout=subprocess.PIPE, stderr=f)
    try:
        deadline = time.monotonic() + 300
        pids = []
        while len(pids) < 3 and time.monotonic() < deadline and p.poll() is None:
            time.sleep(0.5)
            pids = _follower_pids(err.read_text())
        assert len(pids) == 3, err.read_text()[-3000:]
        time.sleep(15.0)  # past the warm-up, into the window
        os.kill(pids[1], signal.SIGKILL)
        t = time.monotonic()
        rc = p.wait(30)
        took = time.monotonic() - t
    finally:
        p.kill()
    print(f"killed rank 2 (pid {pids[1]}): the run ended with {rc} after {took:.2f} s")
    assert rc != 0 and took < 30 and p.stdout.read() == b""
    assert all(_gone(pid) for pid in pids)
