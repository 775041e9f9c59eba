"""The port's ``GraphService`` (on the CPU) held against the reference
package: every coalesced SSSP/BFS answer equals the reference's solo run of
that query bitwise, PPR answers are within ``PPR_RTOL`` of the reference's
K = 1 run (the tolerance and its derivation are ``test_torch_batch.py``'s),
and the batching, admission, memoization and shutdown behaviour is the
reference's (``tests/test_serve_service.py``).
"""
import sys
import threading
import time

import numpy as np
import pytest

from repro.session import GraphSession as RefSession
from repro_torch.serve import (AdmissionError, GraphService, ServiceClosed,
                               ServiceConfig, ServiceStats, percentile)
from repro_torch.session import GraphSession
from tests.test_torch_batch import PPR_RTOL

MAX_ITERS = {"sssp": 100, "bfs": 100, "ppr": 10}


def _hammer_queries(n):
    """64 sssp/bfs queries over 16 distinct landmarks each (repeats let
    coalescing and the memo engage), then 8 ppr queries over 4 seeds."""
    qs = [("sssp", {"source": (i % 16) * 29 % n}) for i in range(32)]
    qs += [("bfs", {"source": ((i % 16) * 41 + 5) % n}) for i in range(32)]
    qs += [("ppr", {"seed": (i % 4) * 97 % n}) for i in range(8)]
    return qs


@pytest.fixture(scope="module")
def ref_solo(graph_store):
    """The reference's answer to one query: a solo ``run`` for sssp/bfs,
    a K = 1 ``run_batch`` for ppr (its solo form)."""
    cache = {}
    sess = RefSession(str(graph_store.path))

    def get(app, **params):
        key = (app, tuple(sorted(params.items())))
        if key not in cache:
            if app == "ppr":
                result = sess.run_batch("ppr", sources=[params["seed"]],
                                        max_iters=MAX_ITERS[app])[0]
            else:
                result = sess.run(app, max_iters=MAX_ITERS[app], **params)
            cache[key] = result.values
        return cache[key]

    yield get
    sess.close()


def _session(graph_store):
    return GraphSession(str(graph_store.path), device="cpu")


def _parked_service(sess, **overrides):
    """A service whose dispatcher holds batches open (so submissions stay
    PENDING deterministically until close() or the batch fills)."""
    kw = dict(max_batch=64, max_wait_ms=60_000.0, max_inflight=1,
              memoize=False)
    kw.update(overrides)
    return GraphService(sess, ServiceConfig(**kw))


def test_hammer_matches_reference_solo_runs(graph_store, ref_solo):
    """8 client threads x 72 queries (64 sssp/bfs, 8 ppr), two runner
    threads: every sssp/bfs result equals the reference's solo run of that
    query bit for bit, however the service coalesced it."""
    queries = _hammer_queries(graph_store.num_vertices)
    results, errors = {}, []
    lock = threading.Lock()
    old_interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)  # interleave client threads finely
    try:
        with _session(graph_store) as sess:
            with sess.service(max_batch=8, max_wait_ms=20.0,
                              max_inflight=2) as svc:
                def client(tid):
                    try:
                        futs = [(i, svc.submit(app, max_iters=MAX_ITERS[app],
                                               **params))
                                for i, (app, params) in enumerate(queries)
                                if i % 8 == tid]
                        for i, f in futs:
                            value = f.result(timeout=300).values
                            with lock:
                                results[i] = value
                    except BaseException as exc:  # noqa: BLE001
                        with lock:
                            errors.append(exc)

                threads = [threading.Thread(target=client, args=(t,))
                           for t in range(8)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                assert not any(t.is_alive() for t in threads)
                assert not errors, errors
                snap = svc.stats.snapshot()
    finally:
        sys.setswitchinterval(old_interval)
    assert len(results) == len(queries)
    for i, (app, params) in enumerate(queries):
        want = ref_solo(app, **params)
        if app == "ppr":
            np.testing.assert_allclose(results[i], want, rtol=PPR_RTOL,
                                       atol=0)
        else:
            np.testing.assert_array_equal(
                results[i], want,
                err_msg=f"query {i} ({app} {params}) diverged from the "
                        "reference's solo run")
    assert snap["completed"] == len(queries)
    assert snap["failed"] == 0 and snap["rejected"] == 0
    assert sum(k * v for k, v in snap["batch_occupancy"].items()) \
        + snap["memo_hits"] == len(queries)
    assert sum(snap["batch_occupancy"].values()) < len(queries)


def test_coalesces_full_batch_deterministically(graph_store, ref_solo):
    """max_wait long and max_batch == the submission count: all four
    queries ride ONE [n, 4] sweep (the occupancy histogram pins it)."""
    with _session(graph_store) as sess:
        with GraphService(sess, ServiceConfig(
                max_batch=4, max_wait_ms=30_000.0, memoize=False)) as svc:
            sources = (0, 5, 9, 42)
            futs = [svc.submit("sssp", source=s, max_iters=100)
                    for s in sources]
            for s, f in zip(sources, futs):
                np.testing.assert_array_equal(f.result(timeout=300).values,
                                              ref_solo("sssp", source=s))
            assert dict(svc.stats.snapshot()["batch_occupancy"]) == {4: 1}
            assert sess.last_batch_result.num_columns == 4


def test_pads_partial_batch_to_power_of_two(graph_store):
    """Three queries ride one K = 4 sweep (the last source duplicated) and
    resolve three futures; occupancy counts the live columns."""
    with _session(graph_store) as sess:
        svc = _parked_service(sess, max_batch=8)
        futs = [svc.submit("bfs", source=s, max_iters=100) for s in (1, 2, 3)]
        svc.close()
        assert sess.last_batch_result.num_columns == 4
        np.testing.assert_array_equal(sess.last_batch_result.values[:, 3],
                                      futs[2].result().values)
        assert svc.stats.snapshot()["batch_occupancy"] == {3: 1}


def test_close_drains_pending_requests(graph_store, ref_solo):
    with _session(graph_store) as sess:
        svc = _parked_service(sess)
        sources = [0, 5, 9]
        futs = [svc.submit("sssp", source=s, max_iters=100) for s in sources]
        assert svc.queue_depth == len(sources)  # parked, not yet dispatched
        svc.close()  # drain=True: pending work runs to completion
        for s, f in zip(sources, futs):
            assert f.done()
            np.testing.assert_array_equal(f.result().values,
                                          ref_solo("sssp", source=s))
        with pytest.raises(ServiceClosed):
            svc.submit("sssp", source=1)
        svc.close()  # idempotent


def test_close_without_drain_fails_pending(graph_store):
    with _session(graph_store) as sess:
        svc = _parked_service(sess)
        futs = [svc.submit("sssp", source=s) for s in (1, 2, 3)]
        svc.close(drain=False)
        for f in futs:
            with pytest.raises(ServiceClosed):
                f.result(timeout=10)
        assert svc.is_closed


def test_admission_rejects_unserved_app_and_full_queue(graph_store):
    with _session(graph_store) as sess:
        with GraphService(sess, ServiceConfig(apps=("sssp",))) as svc:
            svc.submit("sssp", source=0, max_iters=2).result(timeout=60)
            with pytest.raises(AdmissionError, match="not served"):
                svc.submit("cc")
            assert svc.stats.snapshot()["rejected"] == 1
        with GraphService(sess) as svc:
            # served by default: every registered app plus "ppr"; the
            # reference's lp/kcore/... specs come with ROADMAP A7
            for app in ("lp", "kcore", "nonsense"):
                with pytest.raises(AdmissionError, match="not served"):
                    svc.submit(app, source=0)
        svc = _parked_service(sess, max_queue=3)
        futs = [svc.submit("sssp", source=s) for s in (0, 1, 2)]
        with pytest.raises(AdmissionError, match="queue full"):
            svc.submit("sssp", source=3)
        svc.close()  # drains the three admitted requests
        assert all(f.done() and f.exception() is None for f in futs)
        assert svc.stats.snapshot()["rejected"] == 1


def test_submit_validates_parameters(graph_store):
    with _session(graph_store) as sess:
        with GraphService(sess) as svc:
            with pytest.raises(TypeError, match="source"):
                svc.submit("sssp")  # batchable app needs its frontier
            with pytest.raises(ValueError, match=">= 0"):
                svc.submit("sssp", source=-3)


def test_memo_hit_serves_repeat_without_a_sweep(graph_store, ref_solo):
    with _session(graph_store) as sess:
        with sess.service(max_batch=4, max_wait_ms=5.0) as svc:
            first = svc.submit("sssp", source=5, max_iters=100).result(60)
            again = svc.submit("sssp", source=5, max_iters=100).result(60)
            snap = svc.stats.snapshot()
            assert snap["memo_hits"] == 1
            assert snap["cache_served_fraction"] == pytest.approx(0.5)
            assert sum(snap["batch_occupancy"].values()) == 1
            np.testing.assert_array_equal(again.values,
                                          ref_solo("sssp", source=5))
            assert again is first
            # different params are different memo entries
            svc.submit("sssp", source=5, max_iters=1).result(60)
            assert svc.stats.snapshot()["memo_hits"] == 1


def test_solo_apps_and_ppr_microbatch(graph_store, ref_solo):
    """Non-batchable apps run solo through session.run; "ppr" alone is a
    K = 1 micro-batch."""
    with _session(graph_store) as sess:
        with sess.service(memoize=False) as svc:
            cc = svc.submit("cc").result(timeout=300)
            ppr = svc.submit("ppr", seed=7, max_iters=10).result(timeout=300)
        np.testing.assert_array_equal(cc.values, sess.run("cc").values)
    np.testing.assert_allclose(ppr.values, ref_solo("ppr", seed=7),
                               rtol=PPR_RTOL, atol=0)


def test_reconfigure_and_warmup(graph_store, ref_solo):
    with _session(graph_store) as sess:
        with _parked_service(sess, max_batch=4) as svc:
            svc.warmup(apps=("sssp",))  # K = 1, 2, 4 engines
            assert len(sess._engines) >= 3
            futs = [svc.submit("sssp", source=s, max_iters=100)
                    for s in (0, 5)]
            assert svc.queue_depth == 2  # parked behind the 60 s window
            new = svc.reconfigure(max_wait_ms=0.0)
            assert new.max_wait_ms == 0.0 and svc.config is new
            for s, f in zip((0, 5), futs):
                np.testing.assert_array_equal(f.result(timeout=300).values,
                                              ref_solo("sssp", source=s))
            with pytest.raises(ValueError, match="not reconfigurable"):
                svc.reconfigure(max_inflight=4)
        with pytest.raises(ServiceClosed):
            svc.reconfigure(max_batch=4)


def test_unported_service_surfaces_raise(graph_store):
    with _session(graph_store) as sess:
        with sess.service() as svc:
            with pytest.raises(NotImplementedError, match="A8"):
                svc.attach_hub(None)
            with pytest.raises(NotImplementedError, match="A5b"):
                svc.apply_mutations(inserts=[(0, 1)])
            # the barrier lifted: the service still serves
            svc.submit("bfs", source=1, max_iters=3).result(timeout=60)


def test_service_stats_and_percentile():
    vals = [10.0, 20.0, 30.0, 40.0]
    assert percentile(vals, 25) == 10.0 and percentile(vals, 76) == 40.0
    with pytest.raises(ValueError):
        percentile(vals, 0)
    stats = ServiceStats()
    for v in np.random.default_rng(0).permutation(np.arange(1, 101)):
        stats.record_latency(v / 1e3, app="bfs")
    for occ in (1, 2, 2, 16):
        stats.record_batch(occ)
    stats.record_latency(0.0, memo_hit=True)
    snap = stats.snapshot()
    rel = stats.latency_hist.growth ** 0.5 - 1
    assert snap["p50_ms"] == pytest.approx(50.0, rel=rel)
    assert snap["p99_ms"] == pytest.approx(99.0, rel=rel)
    assert snap["mean_ms"] == pytest.approx(5050.0 / 101)
    assert snap["batch_occupancy"] == {1: 1, 2: 2, 16: 1}
    assert snap["cache_served_fraction"] == pytest.approx(1 / 101)
    assert stats._app_hist("bfs").count == 100


def test_service_config_validation():
    with pytest.raises(ValueError, match="max_batch"):
        ServiceConfig(max_batch=0)
    with pytest.raises(ValueError, match="max_inflight"):
        ServiceConfig(max_inflight=0)
    assert ServiceConfig(fair_weights={"b": 2, "a": 1}).fair_weights == \
        (("a", 1.0), ("b", 2.0))


def test_fair_share_orders_ready_groups(graph_store):
    """With every group past its deadline, dispatch alternates apps by
    stride pass — bfs, ppr, bfs."""
    with _session(graph_store) as sess:
        svc = _parked_service(sess, max_batch=2)
        try:
            with svc._cond:
                svc._paused = True  # park the dispatcher
            for s in (0, 1, 2, 3):
                svc.submit("bfs", source=s, max_iters=5)
            svc.submit("ppr", seed=1, max_iters=5)
            far_future = time.perf_counter() + 1e6  # everything expired
            order = []
            with svc._cond:
                cfg = svc.config
                while svc._pending:
                    key = svc._ready_group(cfg, far_future)
                    group = svc._take_group(key, cfg)
                    order.append(tuple(r.app for r in group))
            assert order == [("bfs", "bfs"), ("ppr",), ("bfs", "bfs")]
        finally:
            with svc._cond:
                svc._paused = False
                svc._cond.notify_all()
            svc.close(drain=False)
