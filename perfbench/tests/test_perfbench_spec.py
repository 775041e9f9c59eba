"""Every name in BENCHMARK.json resolves to its files, and the file keeps
the shape the benchmark's contract gives it."""
from __future__ import annotations

import json
import re

import pytest

from perfbench import check, spec
from perfbench.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = spec.resolve(BENCH, cell, ROOT)
    assert c.chips == 1
    assert c.config_path.is_file() and c.traffic_path.is_file()
    assert ROOT / "perfbench" in c.config_path.parents
    apps = {t["app"] for t in c.traffic["requests"]}
    assert {check.check_name(a) for a in apps} <= set(c.traffic["limits"])
    assert callable(c.executor.execute)
    assert any(m.kind == "per_layer" for m in c.metrics)
    assert {m.name for m in c.metrics if m.kind == "end_to_end"} >= {
        "setup_s", "device_mem_peak_gb"}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == config
    assert data["source"] == entry["source"]
    # each cut is a top-level key of the file, and none is a width
    for key in entry["reduced"]:
        assert key in data and NAME.match(key)
        assert not key.endswith(("_dim", "_rank", "_size", "width"))
    assert entry["reduced"] == []


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    BENCH["end_to_end"] + BENCH["per_layer"]])
def test_metric_has_reader(metric):
    m = next(x for x in spec.all_metrics(BENCH) if x.name == metric)
    assert m.path.is_file()
    assert callable(m.reader())
    assert NAME.match(m.name) and UNIT.match(m.unit)
    assert m.entry["better"] in ("lower", "higher")


def test_bounds_and_layers():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200


@pytest.mark.parametrize("traffic", sorted(p.stem for p in
                                           spec.WORKLOADS.glob("*.json")))
def test_traffic_file_resolves_by_name(traffic):
    """Every traffic file, in the benchmark or kept for a later cell, finds
    its executor and each app's reference and comparison by name."""
    t = json.loads((spec.WORKLOADS / f"{traffic}.json").read_text())
    assert callable(spec.executor(t["executor"]).execute)
    for template in t["requests"]:
        app = spec.app(template["app"])
        assert callable(app.reference) and callable(app.compare)
        assert app.CHECK in t["limits"]


def test_unknown_app_has_no_file():
    with pytest.raises(FileNotFoundError):
        spec.app("no_such_app")
