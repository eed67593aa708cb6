"""A cell of the benchmark, found by name.

`BENCHMARK.json` at the checkout's root names each cell (`workloads`) with
its configuration and traffic mix. Every piece is a file of its own, found
by its name, so a later cell, configuration, mix or metric is added by new
files and manifest entries alone:

- a configuration: `benchmark/configs/<config>.json`;
- a traffic mix: `benchmark/traffic/<traffic>.json`;
- a cell's correctness limits: `benchmark/limits/<workload>.json`;
- a per-layer metric: `benchmark/metrics/<name>.py`, a module with
  `read(record) -> float | None`; its unit is the manifest's.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's metric entries this cell reports
    per_layer: list


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json with its files; raises
    FileNotFoundError or KeyError when one is missing."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    bench = root / "benchmark"
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, traffic=traffic, limits=limits,
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)])


def metric_reader(name: str, root: Path = ROOT):
    """The module of per-layer metric `name` (`benchmark/metrics/<name>.py`)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
