"""Nothing the benchmark runs imports the JAX package or its libraries, or
reads the JAX package's benchmarks: compared by whole top-level names,
since the port's name (``repro_torch``) begins with the JAX package's."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

from perfbench import bench
from perfbench.tests.conftest import ROOT

FORBIDDEN = set(bench.FORBIDDEN) | {"benchmarks"}


def _sources():
    return sorted((ROOT / "perfbench").rglob("*.py"))


def test_forbidden_names_are_whole_names():
    assert "repro" in bench.FORBIDDEN and "jax" in bench.FORBIDDEN
    assert "repro_torch" not in bench.FORBIDDEN


def test_no_module_imports_a_forbidden_package():
    bad = []
    for path in _sources():
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad


def test_no_module_reads_the_jax_benchmarks():
    for path in _sources():
        if path.parent.name == "tests":
            continue
        assert "benchmarks/" not in path.read_text(), path


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A whole CPU run at scale 10 in a fresh interpreter, then the names
    of every loaded module."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from perfbench import bench, spec
from perfbench.tests.conftest import cell_from_files, small
cell = small(cell_from_files(spec.load_benchmark(), "g22-jobs"))
r = bench.run_cell(cell, 7, 0.3, False, "cpu", time.perf_counter(),
                   data_root=__import__("pathlib").Path({str(tmp_path)!r}),
                   log=lambda m: None)
print(json.dumps({{"correct": r["correct"],
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert not set(res["top"]) & FORBIDDEN
    assert "repro_torch" in res["top"]
