"""One run of one cell: set-up, the measured window, the check.

``run_cell`` is everything a run does once the device is known; the
command line (``perfbench/run.py``) adds the look for a chip and the
printing.  The window is a closed loop: requests go back to back, one in
flight, for ``seconds``.  A request that completes inside the window counts
its jobs; the one the window's end cuts off counts neither work nor time.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import check, data, traffic
from perfbench.reference import Graph
from perfbench.spec import Cell

HERE = Path(__file__).resolve().parent
PEAKS = HERE / "peaks.json"
# names of the JAX reference package and its libraries; none may be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Completed:
    request: traffic.Request
    t_end: float          # seconds from the window's start
    stats: list           # the program's IterationStats of this request


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: Cell
    graph: data.GraphFiles
    setup_s: float
    seconds: float
    completed: list       # Completed, in order, inside the window
    trace: object | None  # trace.Summary of a traced run
    device_kind: str
    peaks: dict | None    # the device's row of peaks.json, if it has one
    memory_peak_bytes: int = 0  # the window's device peak (0 on the CPU)

    @property
    def jobs(self) -> int:
        return sum(c.request.jobs for c in self.completed)

    @property
    def t_last(self) -> float:
        return self.completed[-1].t_end

    @property
    def stats(self) -> list:
        return [(c.request, s) for c in self.completed for s in c.stats]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def open_session(store: Path, config: dict, device):
    from repro_torch.core.engine import EngineConfig
    from repro_torch.session import GraphSession

    # every field given or the dataclass default: no GRAPHMP_* variable of
    # the environment reaches the configuration
    cfg = EngineConfig(**config["session"])
    return GraphSession(str(store), config=cfg, device=device)


def window(run_request, stream, seconds: float, sink: list, log,
           clock=time.perf_counter):
    """The measured window: requests from ``stream`` back to back until
    ``seconds`` have passed.  -> (completed, answers, cut, failed): the
    requests that completed inside the window (``Completed``) with their
    answers, those the window's end cut off, and how many raised.  ``sink``
    collects the program's IterationStats as they come."""
    completed, answers, cut, failed = [], [], [], 0
    t_start = clock()
    while clock() - t_start < seconds:
        req = next(stream)
        mark = len(sink)
        try:
            with torch.profiler.record_function(req.span):
                values = run_request(req)
        except Exception as exc:  # a failed request is counted, not hidden
            log(f"perfbench: request {req.index} ({req.app}) failed: "
                f"{type(exc).__name__}: {exc}")
            failed += 1
            break
        t_end = clock() - t_start
        mine = sink[mark:]
        log(f"perfbench: request {req.index} {req.app} jobs={req.jobs} "
            f"iterations={len(mine)} "
            f"shards={sum(s.shards_processed for s in mine)} "
            f"fetch_s={sum(s.fetch_seconds for s in mine):.4f} "
            f"seconds={sum(s.seconds for s in mine):.4f} t_end={t_end:.4f}")
        if t_end <= seconds:
            completed.append(Completed(req, t_end, sink[mark:]))
            answers.append(check.Answer(req.app, req.sources, req.args,
                                        req.max_iters, values))
        else:
            cut.append(req)
    return completed, answers, cut, failed


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, data_root: Path = data.DATA, log=None) -> dict:
    """One run; -> the result dict (metrics, check, device) without the
    printing.  ``t0`` is the host clock when the run began (set-up counts
    from it)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    # the program's host work (the staging copies above all) on every core
    # the process may use, as a user of the machine runs it
    torch.set_num_threads(len(os.sched_getaffinity(0)))
    graph = data.ensure_graph(cell.config, data_root)
    store = data.ensure_store(cell.config, graph, data_root)
    pool = np.load(graph.pool)
    log(f"perfbench: data_s={time.perf_counter() - t0:.3f}")
    session = open_session(store, cell.config, device)
    log(f"perfbench: session_s={time.perf_counter() - t0:.3f}")
    if (session.n, session.store.num_edges) != (graph.num_vertices,
                                                  graph.num_arcs):
        raise RuntimeError(
            f"the store holds {session.n} vertices and "
            f"{session.store.num_edges} arcs, the edge list "
            f"{graph.num_vertices} and {graph.num_arcs}")
    sink: list = []
    session.iteration_observers.append(sink.append)

    # warm-up: each template once, on roots of a stream of its own
    ex = cell.executor
    warm = traffic.requests(cell.traffic, pool, traffic.seeded(seed, 0))
    for _ in range(traffic.rotation_length(cell.traffic)):
        ex.execute(session, next(warm))
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    log(f"perfbench: setup_s={setup_s:.3f}")

    stream = traffic.requests(cell.traffic, pool, traffic.seeded(seed, 1))
    prof = _profiler(device) if trace else None
    sink.clear()
    if prof is not None:
        prof.start()
    if hasattr(ex, "window"):
        completed, answers, cut, failed_requests = ex.window(
            session, stream, seconds, sink, log)
    else:
        completed, answers, cut, failed_requests = window(
            lambda req: ex.execute(session, req), stream, seconds, sink, log)
    if prof is not None:
        prof.stop()
    peak = (torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of the JAX package are loaded: {found}")

    summary = None
    if prof is not None:
        summary = _reduce_trace(prof, len(completed))
        del prof
    session.close()
    del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    kind = _device_kind(device)
    run = Run(cell, graph, setup_s, seconds, completed, summary, kind,
              _peaks(kind), int(peak))
    metrics = {}
    for m in cell.metrics_of("per_layer" if trace else "end_to_end"):
        value = m.reader()(run) if completed else None
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}

    t_check = time.perf_counter()
    worst, per_job = _compare(answers, graph, device)
    limits = cell.traffic["limits"]
    ok, table = check.verdict(worst, limits)
    wrong_jobs = sum(1 for name, r in per_job if r > limits[name])
    log(f"perfbench: check_s={time.perf_counter() - t_check:.3f} "
        f"jobs_compared={len(per_job)}")
    attempted = run.jobs + sum(r.jobs for r in cut) + failed_requests
    result = {
        "correct": bool(ok and completed and not failed_requests
                        and not forbidden_modules()),
        "attempted": attempted,
        "failed": wrong_jobs + failed_requests,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": run.device_kind, "count": 1,
                   "memory_peak_bytes": int(peak)},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = table
    return result


def _compare(answers, graph_files: data.GraphFiles, device):
    if not answers:
        return {}, []
    src, dst, w = data.load_edges(graph_files)
    g = Graph.from_numpy(src, dst, w, graph_files.num_vertices, device)
    del src, dst, w
    try:
        return check.compare(answers, g)
    finally:
        del g
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def _profiler(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _reduce_trace(prof, n_done: int):
    from perfbench import trace as tr

    if n_done < 1:
        return None
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        print(f"perfbench: trace_bytes={os.path.getsize(path)}",
              file=sys.stderr, flush=True)
        return tr.summarize(path, "perfbench.", n_done)
    finally:
        os.unlink(path)


def _device_kind(device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _peaks(kind: str) -> dict | None:
    with open(PEAKS) as f:
        return json.load(f).get(kind)
