"""Shared fixtures of the benchmark's own tests: cells of BENCHMARK.json cut
to scale 10 (a few thousand edges, several shards) on the CPU.

Run from the repository's root: ``python -m pytest -q perfbench/tests``.
"""
from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import spec  # noqa: E402

SMALL_SCALE = 10
# arcs a shard holds at the small scale: 32,768 arcs make 16 or so shards
SMALL_SHARD = 2048


def small(cell: spec.Cell, scale: int = SMALL_SCALE) -> spec.Cell:
    """``cell`` with its graph cut to ``scale``; everything else as it is."""
    config = copy.deepcopy(cell.config)
    config["graph"]["scale"] = scale
    # the same number of shards at every small scale
    config["preprocess"]["threshold_edge_num"] = SMALL_SHARD << (
        scale - SMALL_SCALE)
    return spec.Cell(cell.name, cell.chips, config, cell.config_path,
                     cell.traffic, cell.traffic_path, cell.metrics)


@pytest.fixture(scope="session")
def bench():
    return spec.load_benchmark(ROOT)


@pytest.fixture(scope="session")
def data_root(tmp_path_factory):
    return tmp_path_factory.mktemp("perfbench_data")


# every traffic file with its configuration: the cells of BENCHMARK.json
# and the mixes kept for a later cell (PERF.md, section 7)
CELLS = {"g22-bfs-k16": "graph500-22", "g22-jobs": "graph500-22",
         "g22w-sssp-k64": "graph500-22-w"}


def cell_from_files(bench, name: str) -> spec.Cell:
    """A cell read from its traffic and configuration files, whether or not
    BENCHMARK.json lists it, with every metric of the benchmark."""
    config = spec.HERE / "configs" / f"{CELLS[name]}.json"
    traffic = spec.WORKLOADS / f"{name}.json"
    return spec.Cell(name, 1, json.loads(config.read_text()), config,
                     json.loads(traffic.read_text()), traffic,
                     tuple(spec.all_metrics(bench)))


@pytest.fixture(scope="session")
def small_cells(bench):
    return {name: small(cell_from_files(bench, name)) for name in CELLS}
