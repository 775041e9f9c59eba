"""The port's GraphPulse telemetry (``repro_torch.obs.metrics``), on the
CPU: the reference's tests of the Reservoir error bound, MetricsHub wiring,
snapshot schema and JSONL emitter (``tests/test_obs.py``), run against the
port, then the port held against the reference package:

* the same observation sequence fed into both packages' ``Counter``,
  ``Gauge``, ``Reservoir`` and ``MetricsHub`` gives equal snapshots (a
  fixed clock makes ``t`` equal too) and byte-identical JSONL;
* a file either hub emits validates under the other's ``validate_file``,
  and ``python -m repro_torch.obs`` exits as the reference's CLI does;
* ``GraphSession.attach_hub``: the same runs on the same store give the
  same counter, gauge and histogram names in both packages, and equal
  iteration, byte, edge and shard counts and integer cache counters; at
  D = 2 the port's ``engine.devN.*`` counters sum to the totals.

Counters and integer gauges are compared exactly.
"""
import json
import math
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.obs import metrics as ref_metrics
from repro.session import GraphSession as RefSession
from repro_torch.obs import metrics as port_metrics
from repro_torch.obs.metrics import (Counter, Gauge, MetricsHub, Reservoir,
                                     main, validate_file, validate_snapshot)
from repro_torch.serve.graph_service import percentile
from repro_torch.session import GraphSession

SRC = str(Path(__file__).resolve().parents[1] / "src")


# ---------------------------------------------------------------------------
# Reservoir: the documented error bound, pinned
# ---------------------------------------------------------------------------
def test_reservoir_quantile_error_vs_exact_nearest_rank():
    """Relative quantile error <= sqrt(growth) - 1 on heavy-tailed data,
    at every quantile the system reports — the documented contract."""
    rng = np.random.RandomState(7)
    samples = np.exp(rng.normal(-3.5, 1.2, size=5000))  # latency-ish, sec
    res = Reservoir()
    for s in samples:
        res.observe(float(s))
    bound = math.sqrt(res.growth) - 1.0
    ordered = sorted(samples.tolist())
    for q in (10, 50, 90, 95, 99, 99.9):
        exact = percentile(ordered, q)
        approx = res.quantile(q)
        rel = abs(approx - exact) / exact
        assert rel <= bound, f"p{q}: {approx} vs exact {exact}, rel {rel}"


def test_reservoir_exact_moments_and_edges():
    res = Reservoir(min_value=1e-3, max_value=10.0, growth=1.05)
    vals = [0.0, 5e-4, 0.002, 0.5, 2.0, 50.0]  # under-, in-, over-range
    for v in vals:
        res.observe(v)
    assert res.count == len(vals)
    assert res.sum == pytest.approx(sum(vals))
    assert res.min == 0.0 and res.max == 50.0
    assert res.mean == pytest.approx(sum(vals) / len(vals))
    # under-range values report min_value (absolute error <= min_value)
    assert res.quantile(1) == res.min_value
    # over-range values clamp to max_value, never invent a larger number
    assert res.quantile(100) == res.max_value


def test_reservoir_windowed_quantile_from_counts_delta():
    """Subtracting two counts() snapshots yields the percentile of ONLY
    the observations in between — the controller's rolling window."""
    res = Reservoir()
    for _ in range(100):
        res.observe(0.001)
    before = res.counts()
    for _ in range(50):
        res.observe(1.0)
    delta = res.counts() - before
    assert int(delta.sum()) == 50
    # the window contains only ~1.0s observations; lifetime p50 is 1 ms
    assert res.quantile(50, counts=delta) == pytest.approx(1.0, rel=0.02)
    assert res.quantile(50) == pytest.approx(0.001, rel=0.02)


def test_reservoir_empty_and_validation():
    res = Reservoir()
    assert res.quantile(99) == 0.0
    assert res.count == 0 and res.mean == 0.0
    with pytest.raises(ValueError):
        res.quantile(0)
    with pytest.raises(ValueError):
        res.quantile(101)
    with pytest.raises(ValueError):
        Reservoir(min_value=0.0)
    with pytest.raises(ValueError):
        Reservoir(min_value=2.0, max_value=1.0)
    with pytest.raises(ValueError):
        Reservoir(growth=1.0)


def test_reservoir_thread_safety_exact_count():
    res = Reservoir()

    def worker(k):
        for i in range(1000):
            res.observe(1e-3 * (k + 1) + 1e-6 * i)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert res.count == 8000


# ---------------------------------------------------------------------------
# Counter / Gauge
# ---------------------------------------------------------------------------
def test_counter_monotone_and_gauge_last_wins():
    c = Counter()
    c.inc()
    c.inc(2.5)
    assert c.value == pytest.approx(3.5)
    with pytest.raises(ValueError):
        c.inc(-1)
    g = Gauge()
    g.set(4)
    g.set(1.5)
    assert g.value == 1.5


# ---------------------------------------------------------------------------
# MetricsHub: registry, pollers, snapshots, timeseries
# ---------------------------------------------------------------------------
def test_hub_registry_get_or_create_and_adoption():
    hub = MetricsHub()
    assert hub.counter("a") is hub.counter("a")
    assert hub.gauge("b") is hub.gauge("b")
    assert hub.histogram("h") is hub.histogram("h")
    shared = Reservoir()
    shared.observe(0.25)
    assert hub.adopt_histogram("h", shared) is shared
    assert hub.histogram("h") is shared  # adoption replaced the original
    snap = hub.sample()
    assert snap["histograms"]["h"]["count"] == 1


def test_hub_poller_flattening_and_dead_poller():
    hub = MetricsHub()
    hub.register_poller("cache", lambda: {
        "hits": 10, "nested": {"ratio": 0.5, "deep": [1, 2]},
        "mode": "zlib",        # string leaf: a label, skipped
        "enabled": True,       # bool -> 1.0
        "bad": float("nan"),   # non-finite: skipped
    })
    hub.register_poller("dead", lambda: 1 / 0)
    snap = hub.sample()
    g = snap["gauges"]
    assert g["cache.hits"] == 10.0
    assert g["cache.nested.ratio"] == 0.5
    assert g["cache.nested.deep.0"] == 1.0 and g["cache.nested.deep.1"] == 2.0
    assert g["cache.enabled"] == 1.0
    assert "cache.mode" not in g and "cache.bad" not in g
    assert not any(k.startswith("dead") for k in g)  # dead poller ignored
    validate_snapshot(snap)
    hub.unregister_poller("cache")
    assert "cache.hits" not in hub.sample()["gauges"]


def test_hub_sample_schema_and_timeseries():
    fake_now = [100.0]
    hub = MetricsHub(retain=4, clock=lambda: fake_now[0])
    hub.counter("reqs").inc(3)
    hub.gauge("depth").set(7)
    hub.histogram("lat").observe(0.5)
    for i in range(6):  # more samples than the ring retains
        fake_now[0] = 100.0 + i
        validate_snapshot(hub.sample())
    assert len(hub.snapshots) == 4  # bounded ring
    ts = hub.timeseries("depth")
    assert ts == [(2.0, 7.0), (3.0, 7.0), (4.0, 7.0), (5.0, 7.0)]
    (t, h), *_ = hub.timeseries("lat")
    assert h["count"] == 1 and h["p50"] == pytest.approx(0.5, rel=0.02)
    assert hub.timeseries("nope") == []


# ---------------------------------------------------------------------------
# the emitter + schema validation on disk
# ---------------------------------------------------------------------------
def test_hub_emits_validating_jsonl(tmp_path):
    path = tmp_path / "metrics.jsonl"
    hub = MetricsHub(path, emit_interval=0.05)
    hub.counter("serve.requests").inc(5)
    hub.histogram("serve.latency_s").observe(0.01)
    hub.emit()      # explicit emit
    hub.close()     # close emits one final snapshot
    hub.close()     # idempotent
    hub.emit()      # after close: silently dropped
    n = validate_file(path)
    assert n >= 2
    first = json.loads(path.read_text().splitlines()[0])
    assert first["counters"]["serve.requests"] == 5.0


def test_hub_env_knobs(tmp_path, monkeypatch):
    path = tmp_path / "env_metrics.jsonl"
    monkeypatch.setenv("GRAPHMP_METRICS", str(path))
    monkeypatch.setenv("GRAPHMP_METRICS_INTERVAL", "0.05")
    hub = MetricsHub()  # picks both up from the environment
    assert hub.emit_path == path and hub.emit_interval == 0.05
    hub.gauge("x").set(1)
    hub.close()
    assert validate_file(path) >= 1
    monkeypatch.setenv("GRAPHMP_METRICS", "")
    assert MetricsHub().emit_path is None  # empty disables


def test_validate_snapshot_rejects_malformed():
    good = MetricsHub().sample()
    validate_snapshot(good)
    for mutate in (
        lambda s: s.update(v=2),
        lambda s: s.update(t=-1.0),
        lambda s: s.update(t=float("nan")),
        lambda s: s.pop("gauges"),
        lambda s: s["counters"].update(bad=-1.0),
        lambda s: s["gauges"].update(bad=float("inf")),
        lambda s: s["histograms"].update(bad={"count": 1}),  # missing fields
        lambda s: s["histograms"].update(bad={
            **{f: 0.0 for f in ("sum", "min", "max", "mean",
                                "p50", "p90", "p95", "p99")},
            "count": 1.5}),  # non-int count
    ):
        snap = json.loads(json.dumps(good))
        mutate(snap)
        with pytest.raises(ValueError):
            validate_snapshot(snap)
    with pytest.raises(ValueError):
        validate_snapshot([])


def test_validate_file_and_cli(tmp_path, capsys):
    good = tmp_path / "good.jsonl"
    hub = MetricsHub(good, emit_interval=10.0)
    hub.counter("c").inc()
    hub.close()
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"v": 99}\n')
    with pytest.raises(ValueError, match="no snapshots"):
        validate_file(empty)
    with pytest.raises(ValueError, match="bad.jsonl:1"):
        validate_file(bad)
    assert main([str(good)]) == 0
    assert "ok" in capsys.readouterr().out
    assert main([str(good), str(bad)]) == 1
    assert "FAIL" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the port against the reference package
# ---------------------------------------------------------------------------
def _feed(mod, clock):
    """One fixed observation sequence into package ``mod``'s primitives and
    a hub on ``clock``; returns (counter, gauge, reservoir, hub)."""
    rng = np.random.RandomState(11)
    c, g, res = mod.Counter(), mod.Gauge(), mod.Reservoir()
    hub = mod.MetricsHub(clock=clock, retain=8)
    shared = hub.adopt_histogram("serve.latency_s", mod.Reservoir())
    hub.register_poller("cache", lambda: {
        "hits": 3, "ratio": 0.75, "mode": "zlib", "ok": False,
        "parts": [{"bytes": 10}, {"bytes": 20}]})
    for i, v in enumerate(np.exp(rng.normal(-4.0, 1.5, size=400))):
        c.inc(float(v))
        g.set(i)
        res.observe(float(v))
        shared.observe(float(v))
        hub.counter("serve.requests").inc()
        hub.counter("engine.disk_bytes").inc(int(v * 1e6))
        hub.gauge("engine.active_ratio").set(float(v) / 2)
        hub.histogram("engine.iteration_s", growth=1.05).observe(float(v))
    return c, g, res, hub


def test_same_observations_give_equal_snapshots():
    port = _feed(port_metrics, lambda: 4.0)
    ref = _feed(ref_metrics, lambda: 4.0)
    (pc, pg, pr, phub), (rc, rg, rr, rhub) = port, ref
    assert (pc.value, pg.value) == (rc.value, rg.value)
    np.testing.assert_array_equal(pr.counts(), rr.counts())
    assert pr.to_dict(1e3) == rr.to_dict(1e3)
    for q in (1, 50, 90, 99, 99.9, 100):
        assert pr.quantile(q) == rr.quantile(q)
    snaps = [phub.sample(), rhub.sample()]
    assert snaps[0] == snaps[1]
    assert (json.dumps(snaps[0], sort_keys=True)
            == json.dumps(snaps[1], sort_keys=True))
    assert phub.timeseries("serve.requests") == \
        rhub.timeseries("serve.requests")


def test_emitted_files_cross_validate_and_match(tmp_path):
    """Each package's hub file validates under the other's validate_file,
    and the same observations on a fixed clock emit the same bytes."""
    files = {}
    for name, mod in (("port", port_metrics), ("ref", ref_metrics)):
        path = tmp_path / f"{name}.jsonl"
        with mod.MetricsHub(path, emit_interval=60.0,
                            clock=lambda: 2.5) as hub:
            hub.counter("serve.completed").inc(7)
            hub.gauge("serve.queue_depth").set(2)
            hub.histogram("serve.latency_s").observe(0.02)
            hub.emit()
        files[name] = path
    assert ref_metrics.validate_file(files["port"]) == 2
    assert validate_file(files["ref"]) == 2
    assert files["port"].read_bytes() == files["ref"].read_bytes()


@pytest.mark.parametrize("content", [
    None,                       # a hub's own file
    '{"v": 99}\n',              # unknown version
    "\n",                       # no snapshots
    '{"v": 1, "t": 0, "counters": {"c": -1}, "gauges": {}, '
    '"histograms": {}}\n',      # negative counter
], ids=["good", "version", "empty", "negative"])
def test_cli_exit_codes_match_reference(tmp_path, content):
    path = tmp_path / "m.jsonl"
    if content is None:
        with MetricsHub(path, emit_interval=60.0) as hub:
            hub.counter("c").inc()
    else:
        path.write_text(content)
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          str(path)], capture_output=True, text=True,
                         env={"PYTHONPATH": SRC}, timeout=60)
    # python -m repro.obs is SystemExit(repro.obs.metrics.main(argv))
    want = ref_metrics.main([str(path)])
    assert out.returncode == want == (0 if content is None else 1), \
        out.stderr
    assert out.stdout.startswith("ok" if want == 0 else "FAIL")


SESSION_COUNTERS = ("iterations", "disk_bytes", "edges_processed",
                    "shards_processed", "shards_skipped")


def _drive(session, hub):
    assert session.attach_hub(hub) is hub
    session.run("sssp", source=3, max_iters=50)
    session.run("bfs", source=0, max_iters=50)
    session.run_batch("sssp", sources=[1, 5, 9], max_iters=50)
    return hub.sample()


@pytest.mark.parametrize("cache_mode", [0, 1])
def test_session_hub_matches_reference(graph_store, cache_mode):
    path = str(graph_store.path)
    with GraphSession(path, device="cpu", cache_mode=cache_mode) as s:
        got = _drive(s, MetricsHub())
    with RefSession(path, cache_mode=cache_mode) as s:
        want = _drive(s, ref_metrics.MetricsHub())
    for section in ("counters", "gauges", "histograms"):
        assert sorted(got[section]) == sorted(want[section]), section
    for name in SESSION_COUNTERS:
        key = f"session.engine.{name}"
        assert got["counters"][key] == want["counters"][key], key
    assert got["counters"]["session.engine.iterations"] > 0
    ints = {k: v for k, v in want["gauges"].items()
            if k.startswith("session.cache.") and float(v).is_integer()
            and "seconds" not in k}
    assert ints and {k: got["gauges"][k] for k in ints} == ints
    for section in (got, want):
        validate_snapshot(section)
        assert section["histograms"]["session.engine.iteration_s"][
            "count"] == section["counters"]["session.engine.iterations"]


def test_session_hub_lanes_sum_to_totals(graph_store):
    """At D = 2 the per-lane counters split the totals, the partitioned
    cache's sub-reports flatten into gauges, and the totals equal a
    one-lane session's."""
    path = str(graph_store.path)
    with GraphSession(path, device="cpu") as s:
        one = _drive(s, MetricsHub())["counters"]
    with GraphSession(path, num_devices=2, device=["cpu"] * 2) as s:
        snap = _drive(s, MetricsHub())
    counters = snap["counters"]
    eng = "session.engine"
    for name in ("disk_bytes", "stall_seconds", "fetch_seconds"):
        lanes = [counters[f"{eng}.dev{d}.{name}"] for d in range(2)]
        assert sum(lanes) == pytest.approx(counters[f"{eng}.{name}"],
                                           rel=1e-12, abs=1e-12), name
    assert f"{eng}.dev2.disk_bytes" not in counters
    assert counters[f"{eng}.disk_bytes"] == one[f"{eng}.disk_bytes"]
    for name in SESSION_COUNTERS:
        assert counters[f"{eng}.{name}"] == one[f"{eng}.{name}"], name
    assert snap["gauges"]["session.cache.partitions.0.hits"] >= 0
