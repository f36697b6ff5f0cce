"""A cell as `BENCHMARK.json` and the data files name it.

Everything is found by name: the configuration's file from its entry in
`configs`, the traffic mix in `traffic/<traffic>.json`, the limits of
the comparison that decides `correct` in `checks/<workload>.json`, the
program's constructor and the plain reference by the configuration's
`family` (`models/<family>.py`, `reference/<family>.py`), the runner by
the mix's `kind` (`harness/<kind>.py`), and each metric's reader in
`metrics/<metric>.py`. Adding a cell, a mix, a configuration, a runner
or a metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List


@dataclass
class Metric:
    name: str
    unit: str
    source: str
    read: Callable[[Dict], object]


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    checks: Dict
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)

    @property
    def family(self):
        return importlib.import_module(f"models.{self.config['family']}")

    @property
    def reference(self):
        return importlib.import_module(f"reference.{self.config['family']}")


def _find(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _reader(bench_dir: Path, name: str) -> Callable[[Dict], object]:
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(root: Path, bench_dir: Path, workload: str) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = _find(bench["workloads"], workload, "workload")
    c = _find(bench["configs"], w["config"], "config")
    cell = Cell(
        name=workload, chips=int(w["chips"]),
        config=json.loads((root / c["file"]).read_text()),
        traffic=json.loads(
            (bench_dir / "traffic" / f"{w['traffic']}.json").read_text()),
        checks=json.loads(
            (bench_dir / "checks" / f"{workload}.json").read_text()))
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if _applies(m, workload):
                getattr(cell, kind).append(Metric(
                    m["name"], m["unit"], m["source"],
                    _reader(bench_dir, m["name"])))
    return cell


def runner(cell: Cell):
    """The runner the cell's traffic names: `harness/<kind>.py`, with
    `run(cell, seed, seconds, trace, device, t_start)`."""
    return importlib.import_module(f"harness.{cell.traffic['kind']}")
