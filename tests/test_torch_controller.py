"""The port's AdaptiveServeController (``repro_torch.obs.controller``), on
the CPU: the reference's control-law tests and close races
(``tests/test_controller.py``) run against the port, then both packages'
controllers fed the same windows must decide the same, tick by tick.

``tick()`` is clock-free (it consumes reservoir/occupancy DELTAS), so a
fake service with hand-fed latencies drives every law branch with no
sleeping and no real traffic.  The close-race tests use a real port
service on the CPU: controller and service must shut down cleanly in
EITHER order.  Decisions are compared exactly: action, knob values, window
size, windowed p99 and occupancy.
"""
import dataclasses
import time

import numpy as np
import pytest

from repro.obs.controller import AdaptiveServeController as RefController
from repro.serve import graph_service as ref_service
from repro_torch.obs.controller import (AdaptiveServeController,
                                        ControllerConfig)
from repro_torch.serve import graph_service as port_service
from repro_torch.serve.graph_service import (GraphService, ServiceClosed,
                                             ServiceConfig)
from repro_torch.session import GraphSession


class FakeService:
    """stats + config + reconfigure — all the controller touches.  ``mod``
    is the package whose ServiceConfig/ServiceStats/ServiceClosed it uses
    (the port's by default)."""

    def __init__(self, mod=port_service, **cfg):
        self.mod = mod
        self.config = mod.ServiceConfig(**cfg)
        self.stats = mod.ServiceStats()
        self.queue_depth = 0
        self.reconfigures: list[dict] = []
        self.closed = False

    def reconfigure(self, **changes):
        if self.closed:
            raise self.mod.ServiceClosed("service is closing")
        self.reconfigures.append(changes)
        self.config = dataclasses.replace(self.config, **changes)
        return self.config

    def feed(self, latency_s: float, n: int = 16, occupancy: int = 1):
        """n completed requests at latency_s, in batches of `occupancy`."""
        for _ in range(n):
            self.stats.record_latency(latency_s)
        for _ in range(max(n // occupancy, 1)):
            self.stats.record_batch(occupancy)


def make(svc=None, **overrides) -> tuple:
    svc = svc if svc is not None else FakeService(max_batch=8,
                                                 max_wait_ms=5.0)
    config = overrides.pop("config", None)
    if config is None:
        overrides.setdefault("slo_p99_ms", 50.0)
    ctl = AdaptiveServeController(svc, config, **overrides)
    return svc, ctl


# ---------------------------------------------------------------------------
# the law, branch by branch
# ---------------------------------------------------------------------------
def test_raise_wait_on_low_occupancy_under_slo():
    svc, ctl = make()
    svc.feed(0.005, n=32, occupancy=1)  # 5 ms << 50 ms SLO, singleton sweeps
    d = ctl.tick()
    assert d.action == "raise_wait"
    assert svc.config.max_wait_ms > 5.0
    assert svc.reconfigures == [dict(max_batch=8,
                                     max_wait_ms=svc.config.max_wait_ms)]


def test_shrink_wait_on_breach_with_low_occupancy_terminates():
    svc, ctl = make()
    for i in range(60):
        svc.feed(0.2, n=16, occupancy=1)  # 200 ms >> SLO, window suspect
        d = ctl.tick()
        if svc.config.max_wait_ms <= ctl.config.min_wait_ms:
            break
        assert d.action == "shrink_wait", d
    # the progress floor walks the window all the way down, then holds
    assert svc.config.max_wait_ms == ctl.config.min_wait_ms
    svc.feed(0.2, n=16, occupancy=1)
    d = ctl.tick()
    assert d.action == "hold" and "limits" in d.reason


def test_raise_wait_on_breach_with_coalescing_occupancy():
    """A breach with full-ish sweeps is queueing, not straggler-waiting:
    the right move is MORE coalescing (wider window), never less."""
    svc, ctl = make()
    svc.feed(0.2, n=32, occupancy=4)  # breach, mean occupancy 4 >= 2.0
    d = ctl.tick()
    assert d.action == "raise_wait" and "coalescing" in d.reason
    assert svc.config.max_wait_ms > 5.0


def test_raise_batch_on_breach_with_deep_queue_and_clamp():
    svc, ctl = make(max_batch_limit=16)
    for _ in range(10):
        svc.queue_depth = 10 * svc.config.max_batch
        svc.feed(0.2, n=16, occupancy=4)
        ctl.tick()
    assert svc.config.max_batch == 16  # stepped up, hard-clamped at limit
    assert any(len(ctl.decisions) and d.action == "raise_batch"
               for d in ctl.decisions)


def test_hysteresis_band_holds():
    svc, ctl = make(hysteresis=0.15)
    svc.feed(0.055, n=32, occupancy=1)  # 55 ms: above SLO, inside the band
    d = ctl.tick()
    assert d.action == "hold" and ctl.adjustments == 0


def test_predictive_guard_blocks_risky_raise():
    # p99 ~40 ms, low band 42.5 ms: headroom is 2.5 ms, but the smallest
    # raise would add 5 ms of potential wait -> the guard holds
    svc, ctl = make(svc=FakeService(max_batch=8, max_wait_ms=10.0))
    svc.feed(0.040, n=32, occupancy=1)
    d = ctl.tick()
    assert d.action == "hold" and "risk" in d.reason


def test_wait_raise_clamped_at_limit():
    svc, ctl = make(max_wait_ms_limit=12.0)
    for _ in range(20):
        svc.feed(0.001, n=16, occupancy=1)
        ctl.tick()
    assert svc.config.max_wait_ms <= 12.0


def test_thin_window_holds_and_counts_toward_convergence():
    svc, ctl = make(settle_ticks=3)
    svc.feed(0.2, n=4)  # 4 < min_samples=8: never trusted
    for _ in range(3):
        d = ctl.tick()
        assert d.action == "hold" and "thin" in d.reason
    assert ctl.converged and ctl.adjustments == 0


def test_no_oscillation_on_steady_in_band_traffic():
    """Steady traffic with p99 inside the band: zero knob moves, converged
    latches, and stays latched."""
    svc, ctl = make(settle_ticks=5)
    for _ in range(12):
        svc.feed(0.048, n=32, occupancy=2)
        assert ctl.tick().action == "hold"
    assert ctl.converged and ctl.adjustments == 0
    svc.feed(0.005, n=32, occupancy=1)  # regime change: headroom appears
    assert ctl.tick().action == "raise_wait"
    assert not ctl.converged  # adjustment resets settling


def test_converged_after_breach_recovery():
    svc, ctl = make(settle_ticks=2)
    svc.feed(0.2, n=16, occupancy=1)
    assert ctl.tick().action == "shrink_wait"
    for _ in range(2):
        svc.feed(0.048, n=16, occupancy=1)
        ctl.tick()
    assert ctl.converged and ctl.adjustments == 1


def test_decisions_history_and_publish_to_hub():
    from repro_torch.obs import MetricsHub

    hub = MetricsHub()
    svc = FakeService(max_batch=8, max_wait_ms=5.0)
    ctl = AdaptiveServeController(svc, hub=hub, slo_p99_ms=50.0, history=4)
    for _ in range(6):
        svc.feed(0.2, n=16, occupancy=1)
        ctl.tick()
    assert len(ctl.decisions) == 4  # bounded
    snap = hub.sample()
    assert snap["gauges"]["controller.max_wait_ms"] == svc.config.max_wait_ms
    assert snap["counters"]["controller.adjustments"] >= 1
    assert ctl.last_decision is ctl.decisions[-1]


def test_tick_propagates_service_closed():
    svc, ctl = make()
    svc.closed = True
    svc.feed(0.2, n=16, occupancy=1)
    with pytest.raises(ServiceClosed):
        ctl.tick()


def test_config_validation_and_overrides():
    with pytest.raises(ValueError):
        ControllerConfig(slo_p99_ms=0)
    with pytest.raises(ValueError):
        ControllerConfig(min_batch=0)
    with pytest.raises(ValueError):
        ControllerConfig(min_wait_ms=5, max_wait_ms_limit=1)
    with pytest.raises(ValueError):
        ControllerConfig(hysteresis=1.0)
    with pytest.raises(ValueError):
        ControllerConfig(step=1.0)
    base = ControllerConfig(slo_p99_ms=99.0)
    _, ctl = make(svc=None, config=base, step=2.0)
    assert ctl.config.slo_p99_ms == 99.0 and ctl.config.step == 2.0


# ---------------------------------------------------------------------------
# close races against a REAL service (either shutdown order is clean)
# ---------------------------------------------------------------------------
def _real_service(graph_store):
    sess = GraphSession(str(graph_store.path), device="cpu")
    svc = GraphService(sess, ServiceConfig(max_batch=4, max_wait_ms=2.0))
    return sess, svc


def test_close_service_then_stop_controller(graph_store):
    sess, svc = _real_service(graph_store)
    try:
        ctl = AdaptiveServeController(svc, slo_p99_ms=50.0, interval_s=0.01)
        ctl.start()
        svc.submit("bfs", source=0, max_iters=50).result(timeout=120)
        svc.close(drain=True)   # service goes first
        deadline = time.monotonic() + 5.0
        while ctl._thread is not None and ctl._thread.is_alive():
            if time.monotonic() > deadline:
                raise AssertionError("controller loop did not exit")
            time.sleep(0.01)
        ctl.stop()              # already-dead loop: still clean
        assert ctl.error is None
    finally:
        sess.close()


def test_stop_controller_then_close_service(graph_store):
    sess, svc = _real_service(graph_store)
    try:
        with AdaptiveServeController(svc, slo_p99_ms=50.0,
                                     interval_s=0.01) as ctl:
            svc.submit("bfs", source=1, max_iters=50).result(timeout=120)
        # controller stopped by the context exit; service still live
        assert ctl.error is None
        assert svc.submit("bfs", source=2,
                          max_iters=50).result(timeout=120) is not None
        svc.close(drain=True)
    finally:
        sess.close()


# ---------------------------------------------------------------------------
# the port against the reference package: equal decisions, tick by tick
# ---------------------------------------------------------------------------
def _schedule(seed: int, ticks: int = 60):
    """Hand-made windows (latency_s, n, occupancy, queue_depth) that walk
    every branch: headroom, breaches with and without coalescing, deep
    queues, in-band holds and thin windows, then a seeded random tail."""
    fixed = [(0.005, 32, 1, 0), (0.005, 32, 1, 0), (0.2, 16, 1, 0),
             (0.2, 32, 4, 0), (0.2, 16, 4, 80), (0.2, 16, 4, 120),
             (0.048, 32, 2, 0), (0.055, 32, 1, 0), (0.2, 4, 1, 0),
             (0.040, 32, 1, 0), (0.001, 16, 1, 0), (0.3, 16, 1, 0)]
    rng = np.random.RandomState(seed)
    tail = [(float(np.exp(rng.uniform(np.log(1e-3), np.log(0.5)))),
             int(rng.randint(0, 48)), int(rng.choice([1, 2, 4, 8])),
             int(rng.choice([0, 4, 40, 200])))
            for _ in range(ticks - len(fixed))]
    return fixed + tail


@pytest.mark.parametrize("seed,overrides", [
    (0, {}),
    (1, dict(max_batch_limit=16, settle_ticks=3)),
    (2, dict(hysteresis=0.3, step=2.0, min_wait_step_ms=1.0)),
    (3, dict(slo_p99_ms=20.0, coalesce_occupancy=3.0, min_samples=4)),
])
def test_decisions_match_reference(seed, overrides):
    fakes = [FakeService(mod, max_batch=8, max_wait_ms=5.0)
             for mod in (port_service, ref_service)]
    overrides = {"slo_p99_ms": 50.0, **overrides}
    ctls = [AdaptiveServeController(fakes[0], **overrides),
            RefController(fakes[1], **overrides)]
    actions = set()
    for latency, n, occupancy, depth in _schedule(seed):
        got = []
        for svc, ctl in zip(fakes, ctls):
            svc.queue_depth = depth
            if n:
                svc.feed(latency, n=n, occupancy=occupancy)
            got.append(dataclasses.astuple(ctl.tick()))
        assert got[0] == got[1]
        actions.add(got[0][1])
        assert fakes[0].config.max_batch == fakes[1].config.max_batch
        assert fakes[0].config.max_wait_ms == fakes[1].config.max_wait_ms
    assert fakes[0].reconfigures == fakes[1].reconfigures
    assert (ctls[0].converged, ctls[0].adjustments) == \
        (ctls[1].converged, ctls[1].adjustments)
    assert actions == {"hold", "raise_wait", "shrink_wait", "raise_batch"}
