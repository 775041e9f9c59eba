"""What ``BENCHMARK.json`` names, resolved to the files that hold it.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, found by its name:

- a configuration: the file its entry in ``configs`` gives
  (``perfbench/configs/<config>.json``);
- a traffic mix: ``perfbench/workloads/<traffic>.json``;
- a metric: ``perfbench/metrics/<metric>.py``, a module with
  ``read(run) -> float | None``;
- an application a traffic file names: ``perfbench/apps/<app>.py``, its
  reference and comparison (``perfbench/check.py``);
- the executor a traffic file names under ``executor``:
  ``perfbench/executors/<executor>.py``, with ``execute(session, request)
  -> values``, and optionally ``window(session, stream, seconds, sink,
  log)`` where the executor drives the window itself (several clients), in
  place of the harness's closed loop (``perfbench/bench.py::window``).

So a later change adds a cell or a metric by adding files and entries only.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WORKLOADS = HERE / "workloads"
METRICS = HERE / "metrics"
APPS = HERE / "apps"
EXECUTORS = HERE / "executors"


def load_module(path: Path, kind: str, name: str):
    """The module in ``path``, loaded from its file under a private name."""
    modname = f"perfbench.{kind}._" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(f"no file for {kind} {name!r} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.cache
def app(name: str):
    """The application's reference and comparison, from its own file."""
    return load_module(APPS / f"{name}.py", "apps", name)


@functools.cache
def executor(name: str):
    """The executor a traffic file names, from its own file."""
    return load_module(EXECUTORS / f"{name}.py", "executors", name)


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    kind: str  # "end_to_end" or "per_layer"
    entry: dict

    def applies_to(self, cell: str) -> bool:
        cells = self.entry.get("workloads")
        return cells is None or cell in cells

    @property
    def path(self) -> Path:
        return METRICS / f"{self.name}.py"

    def reader(self):
        """The metric's ``read`` function, loaded from its own file."""
        return load_module(self.path, "metrics", self.name).read


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    config_path: Path
    traffic: dict
    traffic_path: Path
    metrics: tuple  # Metric, every metric this cell reports

    def metrics_of(self, kind: str) -> list[Metric]:
        return [m for m in self.metrics if m.kind == kind]

    @property
    def executor(self):
        return executor(self.traffic["executor"])


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def all_metrics(bench: dict) -> list[Metric]:
    return ([Metric(m["name"], m["unit"], "end_to_end", m)
             for m in bench["end_to_end"]]
            + [Metric(m["name"], m["unit"], "per_layer", m)
               for m in bench["per_layer"]])


def resolve(bench: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` names, with its configuration and traffic read
    from their files; raises KeyError for a name the benchmark lacks."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_path = root / configs[w["config"]]["file"]
    traffic_path = WORKLOADS / f"{w['traffic']}.json"
    with open(config_path) as f:
        config = json.load(f)
    with open(traffic_path) as f:
        traffic = json.load(f)
    metrics = tuple(m for m in all_metrics(bench) if m.applies_to(workload))
    return Cell(workload, int(w["chips"]), config, config_path, traffic,
                traffic_path, metrics)
