"""Load generation for GraphService (``python -m repro_torch.serve.bench``).

The port of the reference package's ``repro/serve/bench.py``: the same
modes, flags, workload and ``result_digest``, plus ``--device`` (default
``cuda``; ``cpu`` only when asked — without a GPU the default raises, it
never falls back to the CPU).

Three arrival modes:

* **closed** — each of N client threads plays a user: submit one query,
  block on the future, immediately submit the next, so concurrency in
  flight equals the client count.  Throughput-oriented; latency here is
  *conditioned on* the service keeping up (a closed loop slows its own
  arrival rate when the service stalls — the coordinated-omission trap).
* **open** — arrivals follow a schedule independent of service speed:
  Poisson inter-arrivals at a target qps (``LoadTrace.synthesize``), or
  any recorded trace.  Latency is measured from the INTENDED arrival
  time, so a stalled service honestly accumulates queueing delay instead
  of silently throttling the generator.  This is the mode that can
  falsify a batching policy.
* **replay** — open-loop over a saved ``LoadTrace`` file: the same
  traffic, byte for byte, against any policy — how static configs and the
  adaptive controller are compared.

Both generators can ``--record-trace`` what they submitted; replays of
exact app families (sssp/bfs) resolve bitwise-identically run to run
(``result_digest`` in the returned stats), so a recorded trace is a
regression oracle as well as a load profile.

Self-tuning: ``--adaptive`` attaches an ``AdaptiveServeController``
(``--slo-p99-ms`` sets the target) and ``--metrics FILE`` streams
MetricsHub JSONL snapshots for offline inspection (``python -m
repro_torch.obs FILE`` schema-checks them).

Usage::

    PYTHONPATH=src python -m repro_torch.serve.bench --scale 14 \
        --clients 1 4 16
    PYTHONPATH=src python -m repro_torch.serve.bench --mode open --qps 40 \
        --duration 10 --record-trace /tmp/t.jsonl
    PYTHONPATH=src python -m repro_torch.serve.bench --device cpu \
        --mode replay --replay-trace benchmarks/traces/mini_mixed.jsonl \
        --scale 10 --adaptive --slo-p99-ms 60 --metrics /tmp/metrics.jsonl \
        --require-converged
"""
from __future__ import annotations

import argparse
import hashlib
import os
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

from repro_torch.obs import (AdaptiveServeController, LoadTrace, MetricsHub,
                             TraceRecorder)
from repro_torch.serve.graph_service import (AdmissionError, GraphService,
                                             ServiceConfig, percentile)

SEQUENTIAL = ServiceConfig(max_batch=1, max_wait_ms=0.0, max_inflight=1,
                           memoize=False)


def prepare_store(scale: int = 14, edge_factor: int = 8,
                  base_dir: str | os.PathLike | None = None):
    """Preprocess (once, cached on disk) an RMAT graph for serving benches:
    the reference's graph and layout, under a directory of this package's
    own (``repro_torch_serve_bench``) so the two packages never share a
    tree."""
    from repro_torch.graph.generate import materialize, rmat_edges
    from repro_torch.graph.preprocess import preprocess_graph
    from repro_torch.graph.storage import GraphStore, write_edge_list

    base = Path(base_dir or os.environ.get(
        "BENCH_DIR", tempfile.gettempdir())) / "repro_torch_serve_bench"
    tag = f"s{scale}_e{edge_factor}"
    out = base / f"store_{tag}"
    if (out / "property.json").exists():
        return GraphStore(out)
    src, dst = materialize(rmat_edges(scale=scale, edge_factor=edge_factor,
                                      seed=11))
    el = base / f"el_{tag}"
    if not (el / "meta.json").exists():
        write_edge_list(el, [(src, dst)], num_vertices=1 << scale)
    return preprocess_graph(str(el), str(out),
                            threshold_edge_num=1 << max(scale - 2, 10),
                            lane=16)


def run_load(session, *, clients: int, queries_per_client: int,
             config: ServiceConfig, app: str = "ppr", max_iters: int = 30,
             seed: int = 0, warmup: bool = True,
             recorder: TraceRecorder | None = None) -> dict:
    """Drive one closed-loop experiment; returns throughput + latency stats.

    Every client issues ``queries_per_client`` queries of ``app`` from
    deterministic, per-client-distinct sources (seeded), so runs are
    reproducible and memoization cannot shortcut the measurement — the
    speedup under test comes from COALESCING alone.  ``recorder`` (a
    ``TraceRecorder``) captures each submission at its actual offset, so a
    closed-loop run can be re-played open-loop later.
    """
    from repro_torch.core.apps import batch_spec

    n = session.n
    spec = batch_spec(app)
    param = spec.source_param if spec is not None else None
    with GraphService(session, config) as svc:
        if warmup:
            svc.warmup(apps=(app,))
        errors: list[BaseException] = []
        lock = threading.Lock()

        def client(cid: int) -> None:
            for i in range(queries_per_client):
                # distinct sources per (client, query): no two in-flight
                # queries collapse to the same column or memo entry
                source = (seed + cid * queries_per_client + i) * 9973 % n
                try:
                    kw = {param: source} if param else {}
                    kw["max_iters"] = max_iters
                    if recorder is not None:
                        recorder.record(app, kw)
                    fut = svc.submit(app, **kw)
                    fut.result()
                except BaseException as exc:  # noqa: BLE001 — reported below
                    with lock:
                        errors.append(exc)
                    return

        threads = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        snap = svc.stats.snapshot()
    total = clients * queries_per_client
    occ = snap["batch_occupancy"]
    batches = sum(occ.values())
    return dict(
        clients=clients, queries=total, wall_seconds=wall,
        qps=total / max(wall, 1e-9),
        p50_ms=snap["p50_ms"], p95_ms=snap["p95_ms"], p99_ms=snap["p99_ms"],
        mean_occupancy=(sum(k * v for k, v in occ.items()) / batches
                        if batches else 0.0),
        batches=batches, disk_bytes=session.stats.disk_bytes,
    )


def replay_trace(session, trace: LoadTrace, config: ServiceConfig, *,
                 adaptive: bool = False, slo_p99_ms: float = 50.0,
                 controller_interval_s: float = 0.25,
                 controller_overrides: dict | None = None,
                 hub: MetricsHub | None = None, warmup: bool = True,
                 speed: float = 1.0, result_timeout: float = 600.0,
                 on_result=None) -> dict:
    """Open-loop replay of ``trace`` against one policy; returns stats.

    A pacer thread submits each event at its recorded offset (divided by
    ``speed``); per-request latency runs from the INTENDED arrival to
    future resolution, so generator lateness and queueing both count
    (open-loop honesty).  Reported percentiles here are EXACT nearest-rank
    over the replay's own latency list — the replay is the judge of the
    serving stack's reservoirs, so it must not share their error bar.

    ``adaptive=True`` attaches an ``AdaptiveServeController`` targeting
    ``slo_p99_ms`` (clamp/gain tweaks via ``controller_overrides``); the
    returned dict then carries ``converged``/``adjustments`` and the final
    knob values.  ``hub`` wires service + session + controller telemetry.

    ``result_digest`` is a SHA-256 over every completed result's value
    bytes in event order: replaying the same trace twice on the same graph
    must produce the same digest for exact app families (sssp/bfs),
    whatever batches the policy formed — the determinism acceptance bar.
    ``on_result(i, event, result)``, when given, sees each completed
    request in event order (how a caller keeps a few results to hold
    against solo runs).
    """
    events = list(trace)
    lats: list = [None] * len(events)
    done_t: list = [None] * len(events)
    futures: list = [None] * len(events)
    with GraphService(session, config) as svc:
        if hub is not None:
            svc.attach_hub(hub)
            session.attach_hub(hub)
        ctl = None
        if adaptive:
            ctl = AdaptiveServeController(
                svc, slo_p99_ms=slo_p99_ms,
                interval_s=controller_interval_s, hub=hub,
                **(controller_overrides or {}))
        try:
            if warmup:
                svc.warmup(apps=tuple(sorted({e.app for e in events})))
            if ctl is not None:
                ctl.start()
            t0 = time.perf_counter()

            def pace() -> None:
                for i, e in enumerate(events):
                    intended = t0 + e.t / speed
                    delay = intended - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    def _done(fut, i=i, intended=intended):
                        done_t[i] = time.perf_counter()
                        lats[i] = done_t[i] - intended
                    try:
                        fut = svc.submit(e.app, **e.params)
                    except AdmissionError as exc:
                        futures[i] = exc
                        continue
                    futures[i] = fut
                    fut.add_done_callback(_done)

            pacer = threading.Thread(target=pace, name="trace-pacer",
                                     daemon=True)
            pacer.start()
            pacer.join()
            digest = hashlib.sha256()
            completed = rejected = failed = 0
            for i, (e, fut) in enumerate(zip(events, futures)):
                if fut is None or isinstance(fut, Exception):
                    rejected += 1
                    continue
                try:
                    res = fut.result(result_timeout)
                except Exception:
                    failed += 1
                    continue
                completed += 1
                digest.update(np.ascontiguousarray(res.values).tobytes())
                if on_result is not None:
                    on_result(i, e, res)
            wall = max((t for t in done_t if t is not None),
                       default=t0) - t0
            snap = svc.stats.snapshot()
            if ctl is not None:
                # post-drain settle: with traffic gone every window is thin,
                # each tick is a hold, and `converged` latches after
                # settle_ticks of them — bounded grace, not an open wait
                grace = (3 * ctl.config.settle_ticks
                         * max(controller_interval_s, 0.05))
                deadline = time.perf_counter() + grace
                while (not ctl.converged and ctl.error is None
                       and time.perf_counter() < deadline):
                    time.sleep(controller_interval_s / 2)
        finally:
            if ctl is not None:
                ctl.stop()
            if hub is not None:
                hub.sample()  # capture the final serving state in-ring
    got = sorted(v for v in lats if v is not None)
    occ = snap["batch_occupancy"]
    batches = sum(occ.values())
    out = dict(
        events=len(events), completed=completed, rejected=rejected,
        failed=failed, wall_seconds=wall,
        qps=completed / max(wall, 1e-9),
        p50_ms=percentile(got, 50) * 1e3, p95_ms=percentile(got, 95) * 1e3,
        p99_ms=percentile(got, 99) * 1e3,
        mean_ms=float(np.mean(got)) * 1e3 if got else 0.0,
        mean_occupancy=(sum(k * v for k, v in occ.items()) / batches
                        if batches else 0.0),
        batches=batches, result_digest=digest.hexdigest(),
        max_batch=svc.config.max_batch, max_wait_ms=svc.config.max_wait_ms,
    )
    if ctl is not None:
        out.update(converged=ctl.converged, adjustments=ctl.adjustments,
                   controller_ticks=ctl.ticks,
                   controller_error=repr(ctl.error) if ctl.error else None)
    return out


def _default_trace(n: int, *, qps: float, duration_s: float,
                   seed: int) -> LoadTrace:
    """The standard mixed open-loop workload: cheap bfs majority + sssp,
    with a 3x burst through the middle third (the regime change an
    adaptive policy has to ride out).  Exact apps only, so replays are
    bitwise-reproducible."""
    return LoadTrace.synthesize(
        duration_s=duration_s, qps=qps, mix={"bfs": 3.0, "sssp": 1.0},
        num_vertices=n, seed=seed, max_iters=32,
        burst=(duration_s / 3, 2 * duration_s / 3, 3.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="GraphService load generator (closed / open / replay)")
    ap.add_argument("--mode", choices=("closed", "open", "replay"),
                    default="closed")
    ap.add_argument("--scale", type=int, default=14,
                    help="RMAT scale (2^scale vertices)")
    ap.add_argument("--edge-factor", type=int, default=8)
    ap.add_argument("--graph", default=None,
                    help="serve an existing preprocessed graph instead of "
                         "generating one")
    # closed-loop shape
    ap.add_argument("--clients", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--queries", type=int, default=8,
                    help="queries per client (closed mode)")
    ap.add_argument("--app", default="ppr",
                    help="closed-mode app: ppr / sssp / bfs / cc / pagerank")
    ap.add_argument("--max-iters", type=int, default=30)
    # open-loop shape
    ap.add_argument("--qps", type=float, default=40.0,
                    help="open-mode Poisson arrival rate")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="open-mode trace length, seconds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--speed", type=float, default=1.0,
                    help="replay time compression factor")
    # policy
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=25.0)
    ap.add_argument("--max-inflight", type=int, default=2)
    # traces
    ap.add_argument("--record-trace", default=None, metavar="FILE",
                    help="save submitted traffic as a LoadTrace JSONL")
    ap.add_argument("--replay-trace", default=None, metavar="FILE",
                    help="trace file for --mode replay")
    # self-tuning + telemetry
    ap.add_argument("--adaptive", action="store_true",
                    help="attach the SLO-aware controller (open/replay)")
    ap.add_argument("--slo-p99-ms", type=float, default=50.0)
    ap.add_argument("--controller-interval", type=float, default=0.25)
    ap.add_argument("--metrics", default=None, metavar="FILE",
                    help="stream MetricsHub JSONL snapshots here "
                         "(also honors GRAPHMP_METRICS)")
    ap.add_argument("--device", default="cuda",
                    help="the session's device: cuda (default; raises "
                         "without a GPU) or cpu")
    ap.add_argument("--require-converged", action="store_true",
                    help="exit 1 unless the controller converged cleanly")
    args = ap.parse_args(argv)

    from repro_torch.session import GraphSession

    store = args.graph or prepare_store(args.scale, args.edge_factor)

    if args.mode == "closed":
        recorder = (TraceRecorder(meta={"mode": "closed", "app": args.app})
                    if args.record_trace else None)
        batched = ServiceConfig(max_batch=args.max_batch,
                                max_wait_ms=args.max_wait_ms,
                                max_inflight=args.max_inflight,
                                memoize=False)
        print("policy,clients,qps,p50_ms,p95_ms,p99_ms,mean_occupancy,"
              "disk_MB")
        for clients in args.clients:
            for name, cfg in (("sequential", SEQUENTIAL),
                              ("batched", batched)):
                with GraphSession(store, device=args.device) as session:
                    r = run_load(session, clients=clients,
                                 queries_per_client=args.queries, config=cfg,
                                 app=args.app, max_iters=args.max_iters,
                                 recorder=(recorder if name == "batched"
                                           else None))
                print(f"{name},{clients},{r['qps']:.2f},{r['p50_ms']:.1f},"
                      f"{r['p95_ms']:.1f},{r['p99_ms']:.1f},"
                      f"{r['mean_occupancy']:.2f},{r['disk_bytes']/1e6:.1f}",
                      flush=True)
        if recorder is not None:
            recorder.save(args.record_trace)
            print(f"# recorded {len(recorder)} events -> "
                  f"{args.record_trace}")
        return 0

    # open / replay: one open-loop run against the configured policy
    if args.mode == "replay" and not args.replay_trace:
        ap.error("--mode replay needs --replay-trace FILE")
    cfg = ServiceConfig(max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        max_inflight=args.max_inflight, memoize=False)
    hub = None
    if args.metrics or os.environ.get("GRAPHMP_METRICS"):
        hub = MetricsHub(emit_path=args.metrics or None)
    try:
        with GraphSession(store, device=args.device) as session:
            if args.mode == "replay":
                trace = LoadTrace.load(args.replay_trace)
            else:
                trace = _default_trace(session.n, qps=args.qps,
                                       duration_s=args.duration,
                                       seed=args.seed)
            if args.record_trace:
                trace.save(args.record_trace)
                print(f"# trace: {len(trace)} events -> "
                      f"{args.record_trace}")
            r = replay_trace(session, trace, cfg, adaptive=args.adaptive,
                             slo_p99_ms=args.slo_p99_ms,
                             controller_interval_s=args.controller_interval,
                             hub=hub, speed=args.speed)
    finally:
        if hub is not None:
            hub.close()
    print("mode,events,completed,rejected,qps,p50_ms,p95_ms,p99_ms,"
          "mean_occupancy,max_batch,max_wait_ms")
    print(f"{args.mode},{r['events']},{r['completed']},{r['rejected']},"
          f"{r['qps']:.2f},{r['p50_ms']:.1f},{r['p95_ms']:.1f},"
          f"{r['p99_ms']:.1f},{r['mean_occupancy']:.2f},{r['max_batch']},"
          f"{r['max_wait_ms']:.2f}", flush=True)
    print(f"# result_digest={r['result_digest']}")
    if args.adaptive:
        print(f"# controller: ticks={r['controller_ticks']} "
              f"adjustments={r['adjustments']} converged={r['converged']} "
              f"error={r['controller_error']}")
        if args.require_converged and (not r["converged"]
                                       or r["controller_error"]):
            print("# FAIL: controller did not converge cleanly")
            return 1
    if r["failed"]:
        print(f"# FAIL: {r['failed']} requests errored")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
