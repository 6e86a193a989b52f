"""Finding a cell's pieces by name.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own, found from the names in
``BENCHMARK.json``:

  configs/<config>.json     the configuration as run (BENCHMARK.json's
                            ``file``)
  traffic/<traffic>.json    the traffic mix's parameters; its ``kind``
                            names the general driver that reads it,
                            drivers/<kind>.py
  limits/<workload>.json    the limit of each number that decides
                            ``correct``, with the readings it was set from
  metrics/<metric>.py       the reader of one per-layer metric

so that a later change adds a cell, a mix or a metric by adding files and
entries alone.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


def load_module(path: Path) -> ModuleType:
    """A module from a file of the benchmark (a metric's name holds dots,
    so the file is loaded by its path, not imported by name)."""
    mod_spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + path.stem.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with what its names lead to."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]      # the metrics this cell reports untraced
    per_layer: List[dict]       # ... and traced
    root: Path

    def driver(self) -> ModuleType:
        kind = self.traffic["kind"]
        return load_module(self.root / "drivers" / f"{kind}.py")

    def reader(self, metric: str) -> Callable:
        return load_module(self.root / "metrics" / f"{metric}.py").read


def load(bench_path: Path) -> dict:
    with open(bench_path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str, e2e_names: Optional[List[str]] = None
             ) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def find_cell(bench: dict, name: str, root: Path = HERE) -> Cell:
    """The cell ``name`` of the benchmark ``bench``, its files under
    ``root``; KeyError where the benchmark has no such cell."""
    work = {w["name"]: w for w in bench["workloads"]}[name]
    conf = {c["name"]: c for c in bench["configs"]}[work["config"]]
    with open(root.parent / conf["file"]) as f:
        config = json.load(f)
    with open(root / "traffic" / f"{work['traffic']}.json") as f:
        traffic = json.load(f)
    limits_path = root / "limits" / f"{name}.json"
    limits: Dict[str, dict] = {}
    if limits_path.exists():
        with open(limits_path) as f:
            limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(name=name, chips=work["chips"], config=config,
                traffic=traffic, limits=limits, end_to_end=e2e,
                per_layer=per_layer, root=root)
