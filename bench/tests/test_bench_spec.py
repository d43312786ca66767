"""Every name in BENCHMARK.json resolves to its files, the file keeps to the
benchmark's contract, and a new cell is new files and entries only."""
import json
import re
import shutil

import pytest

from bench.harness.spec import ROOT, Spec
from bench.reference import model

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_every_name_resolves():
    spec = Spec()
    for w in spec.data["workloads"]:
        cfg = spec.config(w["config"])
        assert cfg["name"] == w["config"]
        traffic = spec.traffic(w["traffic"])
        kind = spec.driver(traffic["kind"])
        assert callable(kind.Driver) and callable(kind.window)
        assert set(spec.limits(w["name"])) == {"score_gap", "rank_share_p50", "stalled_share",
                                                "bad_answers", "unanswered"}
        objectives = traffic.get("objectives", [cfg["search"]["objective"]])
        assert all(callable(model.objective(o).score) for o in objectives)
        for m in spec.per_layer(w["name"]):
            assert callable(spec.reader(m["name"]))
        assert {m["name"] for m in spec.end_to_end(w["name"])} >= {"setup_s", "searches_per_s"}
        assert spec.per_layer(w["name"])


def test_contract_shape():
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert data["paths"] == ["bench"] and data["command"] == ["python3", "bench/run.py"]
    assert 1 <= data["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in data[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    cells = {w["name"] for w in data["workloads"]}
    pairs = {(w["config"], w["traffic"]) for w in data["workloads"]}
    assert len(pairs) == len(cells)
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in data["end_to_end"]}
    assert "setup_s" in e2e
    for m in data["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in data["end_to_end"] + data["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in data["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert len(json.dumps(data)) < 64 * 1024


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    """A later PR adds a mix and a cell by adding a traffic file, a limits
    file and an entry: the harness finds them with no code changed."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench")
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "bench/traffic/serve-table.json").read_text())
    mix.update(clients=64)
    (tmp_path / "bench/traffic/serve-table-64.json").write_text(json.dumps(mix))
    (tmp_path / "bench/checks/cnn4-serve-64.json").write_text(
        (ROOT / "bench/checks/cnn4-serve-table.json").read_text())
    data["workloads"].append({"name": "cnn4-serve-64", "config": "cnn4",
                              "traffic": "serve-table-64", "chips": 1, "why": "x"})
    for m in data["per_layer"]:
        if "cnn4-serve-table" in m["workloads"]:
            m["workloads"].append("cnn4-serve-64")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    spec = Spec(tmp_path)
    assert spec.traffic(spec.cell("cnn4-serve-64")["traffic"])["clients"] == 64
    assert spec.config("cnn4")["search"]["pop_size"] == 40
    assert spec.limits("cnn4-serve-64") == spec.limits("cnn4-serve-table")
    assert [m["name"] for m in spec.per_layer("cnn4-serve-64")] == \
        [m["name"] for m in spec.per_layer("cnn4-serve-table")]
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


def _add_cell(tmp_path, mix_name, mix, cell, like, per_layer_like):
    """Copy the benchmark, add a traffic file, a limits file and a cell
    entry (listed by the per-layer metrics of ``per_layer_like``)."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench")
    data = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "bench/traffic" / f"{mix_name}.json").write_text(json.dumps(mix))
    (tmp_path / "bench/checks" / f"{cell}.json").write_text(
        (ROOT / "bench/checks" / f"{like}.json").read_text())
    data["workloads"].append({"name": cell, "config": "cnn4", "traffic": mix_name,
                              "chips": 1, "why": "x"})
    for m in data["per_layer"]:
        if per_layer_like in m["workloads"]:
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    return Spec(tmp_path)


def test_a_threefry_sweep_is_files_only(tmp_path):
    """``cnn4-sweep-threefry`` (PERF.md, Open questions): the sweep on the
    threefry streams is a traffic file whose ``engine`` and ``request``
    objects the driver passes on; it runs and is judged with no code
    changed."""
    import time

    from bench.harness.cell import run_cell

    mix = json.loads((ROOT / "bench/traffic/sweep-table.json").read_text())
    mix.update(seeds_per_call=2, engine={"prng": "threefry"},
               request={"backend": "table", "prng": "threefry"})
    spec = _add_cell(tmp_path, "sweep-threefry", mix, "cnn4-sweep-threefry",
                     "cnn4-sweep-kernel", "cnn4-sweep-kernel")
    out = run_cell("cnn4-sweep-threefry", 2 ** 31 + 7, 0.5, False,
                   t_start=time.perf_counter(), device="cpu", spec=spec)
    assert out["checks"]["bad_answers"]["value"] == 0
    assert out["checks"]["score_gap"]["value"] < 1e-4
    assert out["metrics"]["searches_per_s"]["value"] > 0


def test_an_open_loop_with_repeats_is_files_only(tmp_path):
    """An open loop (Poisson arrivals at a fixed rate) with a share of
    repeated requests and a result cache: a traffic file only."""
    import time

    from bench.harness.cell import run_cell

    mix = json.loads((ROOT / "bench/traffic/serve-table.json").read_text())
    mix.update(loop="open", rate_per_s=40.0, repeat_share=0.5, repeat_window=16,
               result_cache={"capacity": 256}, engine={"max_slots": 8, "pipelined": True},
               ramp_s=0.2)
    spec = _add_cell(tmp_path, "serve-open", mix, "cnn4-serve-open",
                     "cnn4-serve-table", "cnn4-serve-table")
    out = run_cell("cnn4-serve-open", 2 ** 31 + 9, 2.0, False,
                   t_start=time.perf_counter(), device="cpu", spec=spec)
    assert out["checks"]["bad_answers"]["value"] == 0
    assert out["checks"]["unanswered"]["value"] == 0
    assert out["checks"]["score_gap"]["value"] < 1e-4
    assert 0 < out["metrics"]["searches_per_s"]["value"] < 80
