"""The rate's arithmetic: a fixed |V| + |E| per completed job, over the
time to the last completion inside the window; a job that the window's end
cuts off adds neither work nor time."""
from __future__ import annotations

import itertools

import pytest

from perfbench import bench, data, traffic
from perfbench.spec import Metric

GRAPH = data.GraphFiles(edge_dir=None, num_vertices=1000, num_edges=15000,
                        num_arcs=30000, weighted=False, n_src=900, n_dst=900,
                        pool=None)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _stream(k):
    for i in itertools.count():
        yield traffic.Request(i, "bfs", k, tuple(range(k)), {}, 10)


def _window(durations, seconds, k=4):
    clock = FakeClock()
    it = iter(durations)

    def run_request(req):
        clock.t += next(it)
        return None

    return bench.window(run_request, _stream(k), seconds, [],
                        lambda msg: None, clock=clock)


def _run(completed, memory_peak_bytes=0):
    return bench.Run(cell=None, graph=GRAPH, setup_s=1.0, seconds=10.0,
                     completed=completed, trace=None, device_kind="cpu",
                     peaks=None, memory_peak_bytes=memory_peak_bytes)


def _evps(run):
    return Metric("evps.traced", "ev/s", "per_layer", {}).reader()(run)


def _mem(run):
    return Metric("device_mem_peak_gb", "GB", "end_to_end", {}).reader()(run)


def test_work_per_job_is_vertices_plus_edges():
    assert GRAPH.work_per_job == 16000


def test_cut_job_adds_nothing():
    completed, answers, cut, failed = _window([3.0, 3.0, 3.0, 3.0], 10.0)
    assert [c.t_end for c in completed] == [3.0, 6.0, 9.0]
    assert len(cut) == 1 and failed == 0 and len(answers) == 3
    # 3 batches of 4 jobs, 16,000 each, over 9 s (not the 10 s window)
    assert _evps(_run(completed)) == 3 * 4 * 16000 / 9.0


def test_rate_ignores_the_window_edge():
    """The same job times give the same rate whatever the window's length,
    as long as the window ends between the same completions."""
    a, *_ = _window([2.0] * 20, 9.0)
    b, *_ = _window([2.0] * 20, 9.9)
    assert _evps(_run(a)) == _evps(_run(b)) == 4 * 16000 / 2.0


def test_completion_on_the_edge_counts():
    completed, _, cut, _ = _window([5.0, 5.0, 5.0], 10.0)
    assert [c.t_end for c in completed] == [5.0, 10.0] and not cut


def test_no_completion_reads_nothing():
    completed, _, cut, _ = _window([12.0], 10.0)
    assert not completed and len(cut) == 1
    assert _evps(_run(completed)) is None


@pytest.mark.parametrize("peak, gb", [(817_233_920, 0.81723392), (0, None)])
def test_device_memory_peak_in_gb(peak, gb):
    """The window's device peak in GB; nothing where no device ran (the
    CPU)."""
    completed, *_ = _window([3.0], 10.0)
    assert _mem(_run(completed, peak)) == gb


def test_failed_request_stops_the_window():
    clock = FakeClock()

    def run_request(req):
        clock.t += 1.0
        if req.index == 2:
            raise RuntimeError("planted")
        return None

    completed, _, _, failed = bench.window(run_request, _stream(2), 10.0,
                                           [], lambda m: None, clock=clock)
    assert len(completed) == 2 and failed == 1


def test_solo_rotation_counts_one_job_each():
    t = {"requests": [{"app": "bfs", "roots": "degree_ge_1",
                       "max_iters": 5}, {"app": "cc", "max_iters": 5}]}
    import numpy as np
    reqs = traffic.requests(t, np.arange(50, dtype=np.int32),
                            traffic.seeded(2**31 + 11, 1))
    first = [next(reqs) for _ in range(4)]
    assert [r.app for r in first] == ["bfs", "cc", "bfs", "cc"]
    assert [r.jobs for r in first] == [1, 1, 1, 1]
    assert len(first[0].sources) == 1 and first[1].sources == ()


def test_same_seed_same_requests():
    import numpy as np
    t = {"requests": [{"app": "bfs", "batch": 16,
                       "roots": "degree_ge_1", "max_iters": 5}]}
    pool = np.arange(1000, dtype=np.int32)

    def first(seed, stream):
        reqs = traffic.requests(t, pool, traffic.seeded(seed, stream))
        return [next(reqs).sources for _ in range(3)]

    assert first(3_000_000_007, 1) == first(3_000_000_007, 1)
    assert first(3_000_000_007, 1) != first(3_000_000_008, 1)
    assert first(3_000_000_007, 0) != first(3_000_000_007, 1)
    assert all(len(set(s)) == 16 for s in first(5, 1))
