"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs[].file``) and a traffic mix
(``bench/traffic/<traffic>.json``), whose ``kind`` names its driver
(``bench/drivers/<kind>.py``); its correctness limits are
``bench/checks/<cell>.json``; each per-layer metric's reader is
``bench/metrics/<metric>.py``; each objective's reference scorer is
``bench/reference/objectives/<objective>.py``.  A new cell, mix, driver,
objective or metric is new files and new entries: nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


class Spec:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "bench" / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> Dict[str, float]:
        return json.loads((self.root / "bench" / "checks" / f"{cell}.json").read_text())

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        return [m for m in self.data["per_layer"] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable:
        """``read(run)`` of ``bench/metrics/<metric>.py``."""
        return _load(self.root / "bench" / "metrics" / f"{metric}.py", "metric").read

    def driver(self, kind: str):
        """The module ``bench/drivers/<kind>.py``: its ``Driver(cfg, traffic,
        seed, device)`` and its ``window(driver, traffic, seconds, trace,
        clock, slices)``."""
        return _load(self.root / "bench" / "drivers" / f"{kind}.py", "driver")


def _load(path: Path, what: str):
    if not path.is_file():
        raise KeyError(f"no {what} file {path}")
    spec = importlib.util.spec_from_file_location(f"bench_{what}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
