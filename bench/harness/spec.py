"""Find a cell and everything it names, by name, from ``BENCHMARK.json``.

A configuration is ``configs/<config>.json``, a traffic mix
``traffic/<traffic>.json`` (which names its generator module in
``generators/``), the configuration names its entry driver
(``drivers/``), frame recipe (``recipes/``) and plain reference
(``references/``), and every metric is ``e2e/<name>.py`` or
``metrics/<name>.py``.  A new cell, configuration, mix or metric is new
files and new entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    module: ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_module(kind: str, name: str, bench_dir: Path = BENCH_DIR
                ) -> ModuleType:
    """``<bench_dir>/<kind>/<name>.py`` as a module of its own."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(workload: str, root: Path = ROOT,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())

    def metrics(kind, entries):
        return [Metric(e["name"], e["unit"],
                       load_module(kind, e["name"], bench_dir))
                for e in entries if _applies(e, workload)]

    return Cell(workload, int(w["chips"]), config, traffic,
                metrics("e2e", bench["end_to_end"]),
                metrics("metrics", bench["per_layer"]))
