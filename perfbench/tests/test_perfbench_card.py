"""The harness on the card at a small scale: each cell correct through the
program's CUDA path, and the traced run reads every per-layer metric.
Skips without a GPU (decided inside the test)."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import bench, spec
from perfbench.tests.conftest import CELLS, ROOT, cell_from_files, small

CARD_SCALE = 16


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_on_the_card(name, data_root):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    cell = small(cell_from_files(spec.load_benchmark(ROOT), name),
                 CARD_SCALE)
    for trace in (False, True):
        r = bench.run_cell(cell, 2**31 + 17, 5.0, trace, "cuda",
                           time.perf_counter(), data_root=data_root,
                           log=lambda m: None)
        assert r["correct"], r["checks"]
        assert r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {m.name for m in cell.metrics_of(
        "per_layer")}
    assert 0 < r["metrics"]["kernel_roofline"]["value"] <= 100
