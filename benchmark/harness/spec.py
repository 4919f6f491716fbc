"""Everything a run needs, found by name: the cell in BENCHMARK.json, its
configuration (benchmark/configs/<config>.json), its traffic mix
(benchmark/traffic/<traffic>.json), the traffic's driver
(benchmark/drivers/<driver>.py), the cell's correctness limits
(benchmark/limits/<workload>.json) and each per-layer metric's reader
(benchmark/metrics/<metric>.py).  Adding a cell or a metric adds files; no
file here names one."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


class SpecError(Exception):
    """The benchmark's files do not describe the requested run."""


def _load_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing {os.path.relpath(path, ROOT)}") from None


def load_module(path: str, name: str) -> ModuleType:
    if not os.path.isfile(path):
        raise SpecError(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: Optional[str] = None
    moves: Optional[str] = None
    workloads: Optional[List[str]] = None

    def applies_to(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    config_name: str = ""
    traffic_name: str = ""
    run_seconds: int = 0
    readers: Dict[str, ModuleType] = field(default_factory=dict)

    bench_dir: str = HERE

    def driver(self) -> ModuleType:
        kind = self.traffic["driver"]
        return load_module(os.path.join(self.bench_dir, "drivers",
                                        f"{kind}.py"),
                           f"benchmark_driver_{kind}")


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _metrics(entries: List[dict]) -> List[Metric]:
    return [Metric(**{k: e.get(k) for k in Metric.__dataclass_fields__})
            for e in entries]


def cell(workload: str, root: str = ROOT, bench: dict = None) -> Cell:
    """The cell named `workload`, with every file it names loaded."""
    bench = benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r} in BENCHMARK.json "
                        f"(have {sorted(cells)})")
    w = cells[workload]
    here = os.path.join(root, "benchmark")
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    traffic = _load_json(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(here, "limits", f"{workload}.json"))
    e2e = [m for m in _metrics(bench["end_to_end"]) if m.applies_to(workload)]
    layer = [m for m in _metrics(bench["per_layer"]) if m.applies_to(workload)]
    c = Cell(name=workload, chips=int(w["chips"]), config=config,
             traffic=traffic, limits=limits, end_to_end=e2e, per_layer=layer,
             config_name=w["config"], traffic_name=w["traffic"],
             run_seconds=int(bench["run_seconds"]), bench_dir=here)
    for m in layer:
        c.readers[m.name] = load_module(
            os.path.join(here, "metrics", f"{m.name}.py"),
            f"benchmark_metric_{m.name.replace('.', '_').replace('-', '_')}")
    return c
