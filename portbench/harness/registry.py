"""Finds a cell's pieces by name.

A cell `<config>.<traffic>` of BENCHMARK.json names a configuration
(`portbench/configs/<config>.json`, through its entry in `configs`), a
traffic mix (`portbench/traffic/<traffic>.json`) and has a file of its own
(`portbench/cells/<cell>.json`: the numbers its check compares and their
limits). The traffic file's `loop` names the loop that drives the program,
`portbench/harness/loops/<loop>.py` with a `drive(run)`. Metrics, end-to-end
and per-layer alike, are readers in `portbench/metrics/<metric>.py`, each
with a `read(ctx)` that returns a number or None.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: dict, cell: str, e2e_names: Optional[List[str]] = None) -> bool:
    """A metric with `workloads` is read in those cells; a per-layer one
    without, in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def load_cell(name: str, root: Path = ROOT, bench: Optional[dict] = None) -> Cell:
    bench = bench or manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    check = load_json(BENCH_DIR / "cells" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, e2e_names)]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                traffic_name=w["traffic"], config=config, traffic=traffic, check=check,
                end_to_end=e2e, per_layer=per_layer)


_modules: Dict[Path, ModuleType] = {}


def _module(path: Path) -> ModuleType:
    """The module in the file `path`, loaded once (a metric's name holds dots,
    so it is loaded from its path, not imported by name)."""
    if path not in _modules:
        spec = importlib.util.spec_from_file_location(f"portbench_file_{len(_modules)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


def metric_reader(name: str) -> Callable:
    """`read(ctx)` of portbench/metrics/<name>.py."""
    return _module(BENCH_DIR / "metrics" / f"{name}.py").read


def loop(name: str) -> ModuleType:
    """portbench/harness/loops/<name>.py, whose `drive(run)` builds the
    program's front end, warms it up and drives it through the window."""
    return _module(BENCH_DIR / "harness" / "loops" / f"{name}.py")
