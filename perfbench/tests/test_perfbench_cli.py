"""The command line: no result without a GPU, and none from a directory
that holds only BENCHMARK.json and the benchmark's own files."""
from __future__ import annotations

import shutil
import subprocess
import sys

import torch

from perfbench.tests.conftest import ROOT

ARGS = ["--workload", "g22-bfs-k16", "--seed", "2147483700", "--seconds",
        "1", "--trace", "0"]


def _run(cwd, code=None):
    cmd = ([sys.executable, "-c", code] if code else
           [sys.executable, "perfbench/run.py", *ARGS])
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          cwd=cwd, env={"PATH": "/usr/bin:/bin"})


def _bare(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_data", "_cache",
                                                  "__pycache__"))
    return tmp_path


def test_no_result_without_a_gpu():
    if torch.cuda.is_available():
        return  # the card's case is the benchmark's own runs
    out = _run(ROOT)
    assert out.returncode != 0
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "cuda" in out.stderr.lower()


def test_no_result_without_the_program(tmp_path):
    """The look for the program's package fails in a bare directory
    (called directly: the look for a GPU comes first on the command
    line)."""
    bare = _bare(tmp_path)
    out = _run(bare, "import sys; sys.path.insert(0, '.'); "
                     "import perfbench.run as r; r._paths(); "
                     "r._port_or_fail(); print('{}')")
    assert out.returncode != 0
    assert "program" in out.stderr
    assert "{}" not in out.stdout
    out = _run(bare)
    assert out.returncode != 0 and "{" not in out.stdout
