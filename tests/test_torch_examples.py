"""The graph examples' twins (``python -m repro_torch.examples.quickstart``
and ``graph_analytics``) against the reference's ``examples/`` scripts.

Each twin runs as a script in a subprocess with ``--device cpu``; that
process loads neither jax nor anything of ``repro``.  Its printed lines
equal the reference example's (run in this process, stdout captured) with
the seconds and edges/s fields masked: shard, edge and vertex counts,
iterations, the top-5, reached counts, components, MB, hit ratios, skipped
shards, the batch lines and the resume deviation.  The ``session:`` line
may differ only by its temporary path and the port's ``device=cpu``.
Without ``--device`` and without a GPU a twin exits non-zero with
``resolve_device``'s message.  The LM twins are in
``tests/test_torch_examples_lm.py``.
"""
import contextlib
import io
import re
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
SRC = str(REPO / "src")

# after the twin's own output: the modules of jax or the reference loaded
_MODULES = (
    "import runpy, sys\n"
    "sys.argv = [{name!r}] + {argv!r}\n"
    "runpy.run_module('repro_torch.examples.{name}', run_name='__main__')\n"
    "print('MODULES', sorted(m for m in sys.modules "
    "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))\n")


def run_twin(name: str, argv: list, timeout: int = 300) -> list:
    """The twin's printed lines; checks it ran and loaded no jax/repro."""
    out = subprocess.run(
        [sys.executable, "-c", _MODULES.format(name=name, argv=argv)],
        capture_output=True, text=True, env={"PYTHONPATH": SRC},
        timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "MODULES []", lines[-1]
    return lines[:-1]


def run_reference(name: str, argv: list, monkeypatch) -> list:
    """The reference example's printed lines, run in this process."""
    monkeypatch.setattr(sys, "argv", [name] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                       run_name="__main__")
    return buf.getvalue().splitlines()


def mask(line: str) -> str:
    line = re.sub(r"[\d.]+M edges/s", "<rate>", line)
    line = re.sub(r"\s*\d+\.\d+s\b", " <s>", line)
    if line.startswith("session: "):
        line = re.sub(r"GraphSession\('[^']*'", "GraphSession(<path>", line)
        line = line.replace(", device=cpu)", ")")
    return line


@pytest.mark.parametrize("name,argv", [
    ("quickstart", []),
    ("graph_analytics", ["--scale", "14"]),
])
def test_graph_twin_prints_the_references_lines(name, argv, monkeypatch):
    got = run_twin(name, argv + ["--device", "cpu"])
    want = run_reference(name, argv, monkeypatch)
    assert [mask(x) for x in got] == [mask(x) for x in want]
    assert len(got) >= 6
    if name == "graph_analytics":  # 3 shards: Bloom skipping shows
        assert " -> 3 shards " in got[0]
        assert "skipped_shards=2" in "\n".join(got)
        assert got[-1].endswith("0.00e+00")


@pytest.mark.parametrize("name", ["quickstart", "serve_lm"])
def test_twin_without_device_needs_cuda(name):
    """``--device`` defaults to the GPU: without one the twin raises
    ``resolve_device``'s error before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable here")
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}"],
        capture_output=True, text=True, env={"PYTHONPATH": SRC},
        timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert out.stdout == ""


def test_graph_twins_return_their_runs():
    """``main`` returns the runs, which ``chip_smoke.py`` holds: quickstart
    its three ``RunResult``s and the landmark batch, graph_analytics its
    runs and the ``IterationStats`` that ``iter_run`` yielded."""
    from repro_torch.examples import graph_analytics, quickstart
    with contextlib.redirect_stdout(io.StringIO()):
        q = quickstart.main(["--device", "cpu"])
        g = graph_analytics.main(["--scale", "12", "--device", "cpu"])
    assert q["batch"].values.shape == (q["pagerank"].values.size, 8)
    assert q["sssp"].converged and q["cc"].converged
    assert q["pagerank"].iterations == 30
    bfs = g["bfs"]
    assert [s.iteration for s in bfs] == list(range(len(bfs))) and bfs
    assert g["full"].iterations == 20
    # the resumed run sweeps iterations 10..19 only
    assert g["resumed"].iterations == g["checkpointed"].iterations == 10
    assert (g["resumed"].values == g["full"].values).all()
