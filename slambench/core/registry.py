"""Finding a cell's pieces by name.

``BENCHMARK.json`` names each cell's configuration and traffic. The
configuration's file is the one ``BENCHMARK.json`` gives; the traffic mix is
``traffic/<traffic>.json``, which names its driver, ``drivers/<driver>.py``;
each per-layer metric is a file of ``metrics/`` that declares ``NAME`` and
``read(trace, cell)``. Drivers and metric readers are loaded by path, so a
later cell, mix or metric is new files and new entries, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List

BENCH_ROOT = Path(__file__).resolve().parents[1]
REPO_ROOT = BENCH_ROOT.parent


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_benchmark(repo: Path = REPO_ROOT) -> dict:
    return json.loads((Path(repo) / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, bench: dict, repo: Path = REPO_ROOT,
            root: Path = BENCH_ROOT) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((Path(repo) / configs[w["config"]]["file"])
                        .read_text())
    traffic = json.loads((Path(root) / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name=workload, config_name=w["config"],
                traffic_name=w["traffic"], chips=int(w["chips"]),
                config=config, traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, workload)])


def _load(path: Path, prefix: str) -> ModuleType:
    name = f"slambench_{prefix}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_driver(cell: Cell, root: Path = BENCH_ROOT) -> ModuleType:
    return _load(Path(root) / "drivers" / f"{cell.traffic['driver']}.py",
                 "driver")


def load_metric_readers(root: Path = BENCH_ROOT) -> Dict[str, Callable]:
    """NAME -> read(trace, cell) of every file in ``metrics/``."""
    readers = {}
    for path in sorted((Path(root) / "metrics").glob("*.py")):
        module = _load(path, "metric")
        if module.NAME in readers:
            raise ValueError(f"metric {module.NAME} declared twice")
        readers[module.NAME] = module.read
    return readers
