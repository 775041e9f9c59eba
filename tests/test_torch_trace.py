"""The port's LoadTrace and replay (``repro_torch.obs.trace``,
``repro_torch.serve.bench``), on the CPU: the reference's format,
synthesis and replay-determinism tests (``tests/test_trace.py``) run
against the port, then the port held against the reference package:

* ``synthesize`` with the same arguments writes byte-identical files in
  both packages, and each package loads the other's;
* the committed ``benchmarks/traces/mini_mixed.jsonl`` (221 events, read
  only) replayed on the store its meta names, built by each package's
  ``prepare_store``, gives the reference's ``result_digest`` with every
  event completed — statically and with the adaptive controller attached.

Replayed sssp/bfs results are compared bitwise (through the digest).
"""
import json
from pathlib import Path

import pytest

from repro.obs import LoadTrace as RefTrace
from repro.serve import bench as ref_bench
from repro.session import GraphSession as RefSession
from repro_torch.obs import LoadTrace, TraceEvent, TraceRecorder
from repro_torch.serve import bench
from repro_torch.serve.bench import ServiceConfig, replay_trace
from repro_torch.session import GraphSession

MINI = Path(__file__).resolve().parents[1] / "benchmarks/traces/mini_mixed.jsonl"
# the replay's time compression: the digest does not depend on it
MINI_SPEED = 4.0


def _tiny_trace(n, events=24, seed=3):
    return LoadTrace.synthesize(
        duration_s=events / 40.0, qps=40.0, mix={"bfs": 2.0, "sssp": 1.0},
        num_vertices=n, seed=seed, max_iters=50)


# ---------------------------------------------------------------------------
# format
# ---------------------------------------------------------------------------
def test_save_load_round_trip(tmp_path):
    trace = _tiny_trace(64)
    trace.meta["store"] = {"scale": 6}
    path = trace.save(tmp_path / "t.jsonl")
    loaded = LoadTrace.load(path)
    assert loaded.meta == trace.meta
    assert len(loaded) == len(trace)
    for a, b in zip(trace, loaded):
        assert (a.app, a.params) == (b.app, b.params)
        assert b.t == pytest.approx(a.t, abs=1e-6)  # t rounds to 6 dp
    # header first, then one event object per line
    lines = path.read_text().splitlines()
    assert json.loads(lines[0])["trace"] == 1
    assert len(lines) == len(trace) + 1


def test_events_sorted_and_introspection():
    trace = LoadTrace([TraceEvent(0.5, "bfs", {"source": 1}),
                       TraceEvent(0.1, "sssp", {"source": 2})])
    assert [e.t for e in trace] == [0.1, 0.5]
    assert trace.duration == 0.5
    assert trace.apps() == {"bfs": 1, "sssp": 1}
    assert trace.mean_qps() == pytest.approx(2 / 0.5)
    assert trace[0].app == "sssp"


def test_load_rejects_malformed(tmp_path):
    cases = {
        "empty.jsonl": "",
        "headeronly.jsonl": '{"trace": 1, "meta": {}}\n',
        "badver.jsonl": '{"trace": 99}\n',
        "notjson.jsonl": "nope\n",
        "negativet.jsonl": '{"t": -1.0, "app": "bfs", "params": {}}\n',
        "noapp.jsonl": '{"t": 0.0, "params": {}}\n',
        "listparams.jsonl": '{"t": 0.0, "app": "bfs", "params": []}\n',
    }
    for name, content in cases.items():
        p = tmp_path / name
        p.write_text(content)
        with pytest.raises(ValueError):
            LoadTrace.load(p)


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------
def test_synthesize_deterministic_and_mixed():
    a = _tiny_trace(128, seed=9)
    b = _tiny_trace(128, seed=9)
    assert a.events == b.events  # bit-for-bit, same seed
    c = _tiny_trace(128, seed=10)
    assert a.events != c.events
    assert set(a.apps()) <= {"bfs", "sssp"}
    assert all(e.params["max_iters"] == 50 for e in a)
    assert all(0 <= e.params["source"] < 128 for e in a)


def test_synthesize_burst_raises_rate():
    base = LoadTrace.synthesize(duration_s=30.0, qps=10.0, mix={"bfs": 1.0},
                                num_vertices=64, seed=1)
    burst = LoadTrace.synthesize(duration_s=30.0, qps=10.0, mix={"bfs": 1.0},
                                 num_vertices=64, seed=1,
                                 burst=(10.0, 20.0, 4.0))
    def inside(tr):
        return sum(1 for e in tr if 10.0 <= e.t < 20.0)
    assert inside(burst) > 2 * inside(base)
    assert burst.meta["burst"] == [10.0, 20.0, 4.0]


def test_synthesize_validation():
    with pytest.raises(ValueError):
        LoadTrace.synthesize(duration_s=0, qps=1, mix={"bfs": 1},
                             num_vertices=8)
    with pytest.raises(ValueError):
        LoadTrace.synthesize(duration_s=1, qps=1, mix={}, num_vertices=8)
    with pytest.raises(ValueError):
        LoadTrace.synthesize(duration_s=1, qps=1, mix={"bfs": -1},
                             num_vertices=8)


# ---------------------------------------------------------------------------
# recorder
# ---------------------------------------------------------------------------
def test_recorder_explicit_and_wall_clock(tmp_path):
    rec = TraceRecorder(meta={"mode": "open"})
    rec.record("bfs", {"source": 1}, t=0.25)   # intended-offset mode
    rec.record("sssp", {"source": 2}, t=0.10)
    assert len(rec) == 2
    trace = rec.trace()
    assert [e.t for e in trace] == [0.10, 0.25]  # sorted on materialize
    path = rec.save(tmp_path / "rec.jsonl")
    assert LoadTrace.load(path).meta == {"mode": "open"}

    fake = [5.0]
    wall = TraceRecorder(clock=lambda: fake[0])
    wall.record("bfs", {})          # first record pins t0 -> t = 0
    fake[0] = 5.5
    wall.record("bfs", {})
    assert [e.t for e in wall.trace()] == [0.0, 0.5]


# ---------------------------------------------------------------------------
# replay determinism: the acceptance bar
# ---------------------------------------------------------------------------
def test_replay_twice_is_bitwise_identical(graph_store):
    """Same trace, two DIFFERENT batching policies: every request resolves
    to the same bytes (exact min-propagation apps), digests match, and the
    replay completes everything it admitted."""
    trace = _tiny_trace(graph_store.num_vertices)
    digests = []
    for cfg in (ServiceConfig(max_batch=2, max_wait_ms=0.5, memoize=False),
                ServiceConfig(max_batch=8, max_wait_ms=25.0, memoize=False)):
        with GraphSession(str(graph_store.path), device="cpu") as session:
            r = replay_trace(session, trace, cfg)
        assert r["completed"] == len(trace)
        assert r["failed"] == 0 and r["rejected"] == 0
        digests.append(r["result_digest"])
    assert digests[0] == digests[1]


def test_open_mode_cli_records_then_replays(graph_store, tmp_path, capsys):
    """Satellite: open-loop Poisson mode end to end through the CLI —
    ``--record-trace`` writes the generated schedule, and ``--mode replay``
    of that file reproduces the run's result digest."""
    rec = tmp_path / "open.jsonl"
    rc = bench.main(["--device", "cpu",
                     "--mode", "open", "--graph", str(graph_store.path),
                     "--qps", "30", "--duration", "0.5", "--seed", "5",
                     "--max-wait-ms", "2.0", "--record-trace", str(rec)])
    assert rc == 0
    out = capsys.readouterr().out
    digest = [ln for ln in out.splitlines()
              if ln.startswith("# result_digest=")][0]
    trace = LoadTrace.load(rec)  # the recorded schedule is a valid trace
    assert len(trace) > 0 and set(trace.apps()) <= {"bfs", "sssp"}
    rc = bench.main(["--device", "cpu",
                     "--mode", "replay", "--graph", str(graph_store.path),
                     "--replay-trace", str(rec), "--max-wait-ms", "25.0"])
    assert rc == 0
    out2 = capsys.readouterr().out
    assert digest in out2  # different policy, same results, same digest


# ---------------------------------------------------------------------------
# the port against the reference package
# ---------------------------------------------------------------------------
def _plain(trace):
    return [(e.t, e.app, e.params) for e in trace], trace.meta


@pytest.mark.parametrize("kw", [
    dict(duration_s=0.6, qps=40.0, mix={"bfs": 2.0, "sssp": 1.0},
         num_vertices=512, seed=3, max_iters=50),
    dict(duration_s=6.0, qps=25.0, mix={"bfs": 3.0, "sssp": 1.0},
         num_vertices=1024, seed=42, max_iters=32, burst=(2.0, 4.0, 3.0)),
    dict(duration_s=2.0, qps=30.0, mix={"bfs": 1.0, "ppr": 1.0, "cc": 0.5},
         num_vertices=300, seed=7, params_by_app={"ppr": {"damping": 0.8}}),
], ids=["tiny", "mini_mixed", "mixed_apps"])
def test_synthesize_matches_reference_bytes(tmp_path, kw):
    port = LoadTrace.synthesize(**kw).save(tmp_path / "port.jsonl")
    ref = RefTrace.synthesize(**kw).save(tmp_path / "ref.jsonl")
    assert port.read_bytes() == ref.read_bytes()
    assert _plain(LoadTrace.load(ref)) == _plain(RefTrace.load(port))
    assert _plain(LoadTrace.load(port)) == _plain(RefTrace.load(ref))


def test_synthesize_reproduces_committed_trace(tmp_path):
    """The committed trace is what ``synthesize`` draws from its meta."""
    meta = LoadTrace.load(MINI).meta
    kw = {k: meta[k] for k in ("duration_s", "qps", "mix", "num_vertices",
                               "seed", "max_iters")}
    trace = LoadTrace.synthesize(**kw, burst=tuple(meta["burst"]))
    trace.meta["store"] = meta["store"]
    assert len(trace) == 221
    assert trace.save(tmp_path / "mini.jsonl").read_bytes() == \
        MINI.read_bytes()


@pytest.fixture(scope="module")
def mini_stores(tmp_path_factory):
    """The store mini_mixed's meta names, built by each package."""
    store = LoadTrace.load(MINI).meta["store"]
    base = tmp_path_factory.mktemp("mini")
    port = bench.prepare_store(store["scale"], store["edge_factor"],
                               base_dir=base)
    ref = ref_bench.prepare_store(store["scale"], store["edge_factor"],
                                  base_dir=base)
    assert port.path != ref.path
    return str(port.path), str(ref.path)


@pytest.fixture(scope="module")
def ref_mini_digest(mini_stores):
    cfg = ServiceConfig(max_batch=16, max_wait_ms=25.0, max_inflight=2,
                        memoize=False)
    with RefSession(mini_stores[1]) as session:
        r = ref_bench.replay_trace(session, RefTrace.load(MINI), cfg,
                                   speed=MINI_SPEED)
    assert r["completed"] == 221
    return r["result_digest"]


@pytest.mark.parametrize("adaptive", [False, True], ids=["static",
                                                         "adaptive"])
def test_mini_mixed_replay_matches_reference_digest(mini_stores,
                                                    ref_mini_digest,
                                                    adaptive):
    cfg = ServiceConfig(max_batch=16, max_wait_ms=25.0, max_inflight=2,
                        memoize=False)
    seen = []
    with GraphSession(mini_stores[0], device="cpu") as session:
        r = replay_trace(session, LoadTrace.load(MINI), cfg,
                         adaptive=adaptive, slo_p99_ms=60.0,
                         speed=MINI_SPEED,
                         on_result=lambda i, e, res: seen.append(i))
    assert (r["events"], r["completed"]) == (221, 221)
    assert seen == list(range(221))  # every result, in event order
    assert r["rejected"] == r["failed"] == 0
    assert r["result_digest"] == ref_mini_digest
    if adaptive:
        assert r["controller_error"] is None and r["controller_ticks"] > 0
