"""The harness's control flow at scale 10 on the CPU, against the
reference: every cell comes out correct as it stands, and not correct with
the timed path broken underneath it (each fault a cell can have), and the
control (the reference one precision lower in the program's place) fails a
limit of every cell.  The look for a chip is skipped: ``run_cell`` is what
a run does once the device is known."""
from __future__ import annotations

import time

import numpy as np
import pytest

from perfbench import bench, control
from perfbench.tests.conftest import CELLS

SECONDS = 1.5


def _run(cell, data_root, seed=2**31 + 3, trace=False):
    # a traced run is slower on the CPU: room for a weighted batch of 64
    return bench.run_cell(cell, seed, 2 * SECONDS if trace else SECONDS,
                          trace, "cpu",
                          time.perf_counter(), data_root=data_root,
                          log=lambda msg: None)


@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_cpu(name, small_cells, data_root):
    r = _run(small_cells[name], data_root)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    # the device's peak is read on a card alone
    assert set(r["metrics"]) == {"setup_s"}
    assert r["metrics"]["setup_s"]["value"] > 0
    assert list(r)[-1] == "checks"
    for row in r["checks"].values():
        assert row["value"] <= row["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_per_layer_metrics(name, small_cells, data_root):
    r = _run(small_cells[name], data_root, trace=True)
    assert r["correct"]
    # on the CPU nothing runs on a device: the device readers read nothing
    assert set(r["metrics"]) == {"evps.traced", "shards_skipped_share",
                                 "fetch_share"}
    assert r["metrics"]["evps.traced"]["value"] > 0
    assert r["device"]["window_s"] > 0
    assert len(r["breakdown"]["idle_gaps"]) <= 10


def test_executor_may_drive_the_window(small_cells, data_root,
                                       monkeypatch):
    """An executor file with ``window`` runs the window in place of the
    closed loop (as a service's clients would), and its answers are
    checked as any."""
    from types import SimpleNamespace

    from perfbench import spec

    session_ex = spec.executor("session")
    calls = []

    def window(session, stream, seconds, sink, log):
        calls.append(seconds)
        return bench.window(lambda r: session_ex.execute(session, r),
                            stream, seconds, sink, log)

    fake = SimpleNamespace(execute=session_ex.execute, window=window)
    monkeypatch.setattr(spec, "executor", lambda name: fake)
    r = _run(small_cells["g22-bfs-k16"], data_root)
    assert calls == [SECONDS] and r["correct"], r["checks"]


def _state_unchanged(monkeypatch):
    from repro_torch.core.engine import VSWEngine

    def sweep(self, program, x, src, aux, it, schedule, epoch_check):
        n = self.n
        return src.clone(), program.changed(src[:n], src[:n])

    monkeypatch.setattr(VSWEngine, "_sweep", sweep)


def _half_batch(monkeypatch):
    from repro_torch.session import GraphSession
    orig = GraphSession.run_batch

    def run_batch(self, app, *, sources, **kw):
        sources = list(sources)
        half = len(sources) // 2
        out = orig(self, app, sources=sources[:half], **kw)
        full = self.last_batch_result.values
        rest = np.full((full.shape[0], len(sources) - half), np.inf,
                       dtype=full.dtype)
        rest[sources[half:], np.arange(len(sources) - half)] = 0.0
        self.last_batch_result.values = np.concatenate([full, rest], axis=1)
        return out

    monkeypatch.setattr(GraphSession, "run_batch", run_batch)


def _answer_altered(monkeypatch):
    from repro_torch.core import engine
    orig = engine.state_to_numpy

    def altered(*args, **kw):
        values, active = orig(*args, **kw)
        values = values.copy()
        flat = values.reshape(-1)
        flat[flat.size // 2] = -1.0  # no app's answer: ranks, hops, ids
        return values, active

    monkeypatch.setattr(engine, "state_to_numpy", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("name,fault", [
    (c, f) for c in CELLS for f in FAULTS
    if not (f == "half_batch" and c == "g22-jobs")])
def test_fault_is_not_correct(name, fault, small_cells, data_root,
                              monkeypatch):
    _run(small_cells[name], data_root)  # data in place before the fault
    FAULTS[fault](monkeypatch)
    r = _run(small_cells[name], data_root)
    assert not r["correct"], (fault, r["checks"])
    assert r["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name, small_cells, data_root):
    """Some control is not correct by the harness's own verdict, on every
    seed; unit BFS is exact in bfloat16, so there the control that stops
    one level short is the one that fails."""
    cell = small_cells[name]
    for seed in (5, 2**31 + 9, 3_000_000_001):
        verdicts = control.control_verdicts(cell, seed, "cpu",
                                            data_root=data_root)
        assert any(not ok for ok, _ in verdicts.values()), verdicts
        assert not verdicts["one_level_short"][0] or name == "g22-jobs"
        if name == "g22-bfs-k16":
            assert verdicts[control.LOW][0], verdicts
