"""SLO-aware adaptive batching controller for GraphService.

The port of the reference package's ``repro/obs/controller.py``: the same
control law, so fed the same windows both packages' controllers make the
same decisions tick by tick.

``ServiceConfig`` fixes ``max_batch``/``max_wait_ms`` up front, but the
right values change minute to minute with traffic: a straggler window that
buys 12-column occupancy at 40 qps is pure added latency at 2 qps, and a
batch cap tuned for PPR seeds is too small when a BFS burst floods the
queue.  NXgraph's lesson (PAPERS.md) — pick the execution strategy from
*observed* conditions, not a priori — applied to the serving layer:

    MetricsHub / ServiceStats reservoirs
        │  (windowed p99, batch occupancy, queue depth)
        ▼
    AdaptiveServeController.tick()          every ``interval_s``
        │  hysteresis band around the SLO, clamped multiplicative steps
        ▼
    GraphService.reconfigure(max_batch=…, max_wait_ms=…)

Control law (one knob move per tick, multiplicative steps, hard clamps):

* **p99 above SLO·(1+hysteresis)** — the service is missing its target,
  and the *cause* decides the direction.  If the queue is deep
  (> 2·max_batch pending) the bottleneck is sweep throughput: raise
  ``max_batch`` so each sweep retires more queries.  Else if batches are
  already coalescing (mean occupancy ≥ ``coalesce_occupancy``) the breach
  is queueing/service time, not straggler-waiting — *raise*
  ``max_wait_ms``: under backlog full groups dispatch immediately, so the
  window cap adds no latency while harder coalescing lifts capacity
  (shrinking here is the classic mistake: it cuts coalescing exactly when
  the service is drowning).  Only when occupancy is low — most sweeps are
  near-singletons, so the window itself is plausibly the latency — shrink
  ``max_wait_ms`` (never by less than ``min_wait_step_ms`` — a 2% shave
  of a 0.01 ms window is not progress).
* **p99 below SLO·(1−hysteresis) with low occupancy and a shallow queue**
  — there is latency headroom being wasted on under-filled sweeps: raise
  ``max_wait_ms`` to harvest occupancy.  Guarded *predictively*: the raise
  is applied only if ``p99 + added_wait`` still clears the lower band, so
  the controller cannot talk itself into a breach it then has to undo
  (the classic limit-cycle oscillation; ``tests/test_torch_controller.py``
  pins steadiness on a steady trace).
* **inside the band** — hold.  ``settle_ticks`` consecutive holds set
  ``converged`` (``serve/bench.py --require-converged`` asserts it).

``tick()`` is deliberately clock-free and deterministic: it consumes only
*deltas* of the stats reservoirs since the previous tick (bin-count
subtraction, see ``Reservoir.quantile(counts=...)``), so unit tests drive
it with a fake service and hand-fed latencies — no sleeping, no wall
clock.  ``start()`` wraps it in a daemon thread for real deployments; the
loop exits cleanly when the service closes under it (``ServiceClosed`` is
the normal shutdown signal, in either close order).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Targets, clamps and gains for ``AdaptiveServeController``.

    slo_p99_ms:
        The latency objective: windowed p99 the controller steers to keep
        below this.
    min_batch / max_batch_limit, min_wait_ms / max_wait_ms_limit:
        Hard clamps on the two knobs — the controller never proposes a
        value outside these, whatever the stats say.
    hysteresis:
        Dead band around the SLO as a fraction: no action while p99 is in
        ``[slo·(1−h), slo·(1+h)]``.  Wider = steadier, slower to react.
    step:
        Multiplicative step per adjustment (batch sizes round up).
    min_wait_step_ms:
        Progress floor for wait-window moves, so repeated shrinks of an
        already-tiny window terminate instead of asymptoting.
    coalesce_occupancy:
        Mean live columns per sweep above which an SLO breach is blamed on
        queueing rather than the straggler window (see the control law:
        raise the window to coalesce harder instead of shrinking it).
    min_samples:
        Minimum completed requests in the tick window before the p99 is
        trusted; thinner windows hold (and count toward settling — no
        traffic is not a reason to twist knobs).
    settle_ticks:
        Consecutive no-adjustment ticks before ``converged`` reports True.
    interval_s:
        Period of the background loop (``start()``); ``tick()`` callers
        set their own cadence.
    """

    slo_p99_ms: float = 50.0
    min_batch: int = 1
    max_batch_limit: int = 64
    min_wait_ms: float = 0.0
    max_wait_ms_limit: float = 50.0
    hysteresis: float = 0.15
    step: float = 1.3
    min_wait_step_ms: float = 0.25
    coalesce_occupancy: float = 2.0
    min_samples: int = 8
    settle_ticks: int = 5
    interval_s: float = 0.25

    def __post_init__(self):
        if self.slo_p99_ms <= 0:
            raise ValueError(f"slo_p99_ms must be > 0, got {self.slo_p99_ms!r}")
        if not 1 <= self.min_batch <= self.max_batch_limit:
            raise ValueError(
                f"need 1 <= min_batch <= max_batch_limit, got "
                f"{self.min_batch!r}, {self.max_batch_limit!r}")
        if not 0 <= self.min_wait_ms <= self.max_wait_ms_limit:
            raise ValueError(
                f"need 0 <= min_wait_ms <= max_wait_ms_limit, got "
                f"{self.min_wait_ms!r}, {self.max_wait_ms_limit!r}")
        if not 0 <= self.hysteresis < 1:
            raise ValueError(f"hysteresis must be in [0, 1), got "
                             f"{self.hysteresis!r}")
        if self.step <= 1.0:
            raise ValueError(f"step must be > 1, got {self.step!r}")


@dataclasses.dataclass(frozen=True)
class Decision:
    """One tick's observation + what (if anything) the controller did."""

    tick: int
    action: str            # raise_batch | shrink_wait | raise_wait | hold
    reason: str            # human-readable why
    window: int            # completed requests observed this window
    p99_ms: float          # windowed p99 (0.0 when window is empty)
    mean_occupancy: float  # mean live columns per batch this window
    queue_depth: int
    max_batch: int         # knob values AFTER this tick
    max_wait_ms: float


class AdaptiveServeController:
    """Feedback loop steering one ``GraphService``'s batching policy.

    Reads the service's reservoir-backed stats (windowed deltas), writes
    through ``service.reconfigure``.  ``tick()`` is synchronous and
    deterministic; ``start()``/``stop()`` run it on a daemon thread.
    Shutdown is safe in either order relative to ``service.close()``:
    ``reconfigure`` on a closing service raises ``ServiceClosed``, which
    the loop treats as a normal stop (never an error).
    """

    def __init__(self, service, config: ControllerConfig | None = None,
                 *, hub=None, history: int = 256, **overrides):
        if config is None:
            config = ControllerConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.service = service
        self.config = config
        self.hub = hub
        self.decisions: deque[Decision] = deque(maxlen=max(history, 1))
        self.error: BaseException | None = None
        self._ticks = 0
        self._settled = 0
        self._adjustments = 0
        self._prev_counts = service.stats.latency_hist.counts()
        self._prev_occ: dict = dict(service.stats.occupancy())
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._tick_lock = threading.Lock()

    # -- observation -----------------------------------------------------
    def _window(self) -> tuple[int, float, float]:
        """(completed, p99_ms, mean_occupancy) since the previous tick."""
        hist = self.service.stats.latency_hist
        counts = hist.counts()
        delta = counts - self._prev_counts
        self._prev_counts = counts
        occ = dict(self.service.stats.occupancy())
        occ_delta = {k: occ.get(k, 0) - self._prev_occ.get(k, 0)
                     for k in set(occ) | set(self._prev_occ)}
        self._prev_occ = occ
        window = int(delta.sum())
        p99_ms = hist.quantile(99, counts=delta) * 1e3 if window else 0.0
        batches = sum(occ_delta.values())
        mean_occ = (sum(k * v for k, v in occ_delta.items()) / batches
                    if batches > 0 else 0.0)
        return window, p99_ms, mean_occ

    # -- the control law -------------------------------------------------
    def tick(self) -> Decision:
        """One control step: observe the window, maybe move ONE knob.

        Raises ``ServiceClosed`` (from ``reconfigure``) if the service shut
        down — callers driving ``tick()`` by hand see it; the background
        loop converts it to a clean stop.
        """
        with self._tick_lock:
            return self._tick_locked()

    def _tick_locked(self) -> Decision:
        ctl = self.config
        window, p99_ms, mean_occ = self._window()
        queue_depth = self.service.queue_depth
        cfg = self.service.config
        batch, wait = cfg.max_batch, cfg.max_wait_ms
        self._ticks += 1
        high = ctl.slo_p99_ms * (1.0 + ctl.hysteresis)
        low = ctl.slo_p99_ms * (1.0 - ctl.hysteresis)

        action, reason = "hold", "p99 within hysteresis band"
        new_batch, new_wait = batch, wait
        if window < ctl.min_samples:
            reason = (f"window too thin ({window} < {ctl.min_samples} "
                      "samples)")
        elif p99_ms > high:
            if queue_depth > 2 * batch and batch < ctl.max_batch_limit:
                # backlog despite full-ish sweeps: grow sweep width
                new_batch = min(ctl.max_batch_limit,
                                max(batch + 1, math.ceil(batch * ctl.step)))
                action = "raise_batch"
                reason = (f"p99 {p99_ms:.1f}ms > {high:.1f}ms with deep "
                          f"queue ({queue_depth})")
            elif (mean_occ >= ctl.coalesce_occupancy
                    and wait < ctl.max_wait_ms_limit):
                # batches already coalesce: the breach is queueing, not
                # straggler-waiting — widen the window to lift capacity
                # (full groups dispatch immediately, so the cap is free)
                new_wait = min(ctl.max_wait_ms_limit,
                               max(wait * ctl.step,
                                   wait + ctl.min_wait_step_ms))
                action = "raise_wait"
                reason = (f"p99 {p99_ms:.1f}ms > {high:.1f}ms with "
                          f"occupancy {mean_occ:.1f} — coalescing harder")
            elif wait > ctl.min_wait_ms:
                # the straggler window itself is the latency: shrink it
                new_wait = max(ctl.min_wait_ms,
                               min(wait / ctl.step,
                                   wait - ctl.min_wait_step_ms))
                action = "shrink_wait"
                reason = f"p99 {p99_ms:.1f}ms > {high:.1f}ms"
            else:
                reason = (f"p99 {p99_ms:.1f}ms over SLO but both knobs at "
                          "their limits")
        elif (p99_ms < low and mean_occ < 0.5 * batch
                and queue_depth <= batch and wait < ctl.max_wait_ms_limit):
            candidate = min(ctl.max_wait_ms_limit,
                            max(wait * ctl.step, wait + ctl.min_wait_step_ms))
            # predictive guard: a longer window can add (candidate - wait)
            # ms to every latency; only raise if that still clears the low
            # band, so this tick cannot force a shrink next tick
            if p99_ms + (candidate - wait) <= low:
                new_wait = candidate
                action = "raise_wait"
                reason = (f"p99 {p99_ms:.1f}ms < {low:.1f}ms, occupancy "
                          f"{mean_occ:.1f}/{batch}")
            else:
                reason = (f"occupancy low but +{candidate - wait:.2f}ms "
                          "wait would risk the SLO")

        if action != "hold":
            # may raise ServiceClosed — deliberately NOT caught here
            self.service.reconfigure(max_batch=new_batch,
                                     max_wait_ms=new_wait)
            self._settled = 0
            self._adjustments += 1
        else:
            self._settled += 1
        decision = Decision(
            tick=self._ticks, action=action, reason=reason, window=window,
            p99_ms=p99_ms, mean_occupancy=mean_occ, queue_depth=queue_depth,
            max_batch=new_batch, max_wait_ms=new_wait)
        self.decisions.append(decision)
        self._publish(decision)
        return decision

    def _publish(self, d: Decision) -> None:
        if self.hub is None:
            return
        try:
            self.hub.gauge("controller.max_batch").set(d.max_batch)
            self.hub.gauge("controller.max_wait_ms").set(d.max_wait_ms)
            self.hub.gauge("controller.window_p99_ms").set(d.p99_ms)
            self.hub.gauge("controller.mean_occupancy").set(d.mean_occupancy)
            self.hub.gauge("controller.converged").set(float(self.converged))
            if d.action != "hold":
                self.hub.counter("controller.adjustments").inc()
        except Exception:
            pass  # telemetry must never take down the control loop

    # -- status ----------------------------------------------------------
    @property
    def converged(self) -> bool:
        """True after ``settle_ticks`` consecutive ticks without a knob
        move (resets on every adjustment)."""
        return self._settled >= self.config.settle_ticks

    @property
    def ticks(self) -> int:
        return self._ticks

    @property
    def adjustments(self) -> int:
        return self._adjustments

    @property
    def last_decision(self) -> Decision | None:
        return self.decisions[-1] if self.decisions else None

    # -- background loop -------------------------------------------------
    def start(self) -> "AdaptiveServeController":
        """Run ``tick()`` every ``interval_s`` on a daemon thread."""
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="graphpulse-controller", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        from repro_torch.serve.graph_service import ServiceClosed

        while not self._stop.wait(self.config.interval_s):
            # a closed service would only surface as ServiceClosed when a
            # tick tries to move a knob; holding ticks would spin forever
            if getattr(self.service, "is_closed", False):
                break
            try:
                self.tick()
            except ServiceClosed:
                break  # the service shut down first: a clean stop
            except Exception as exc:  # noqa: BLE001 — surfaced via .error
                self.error = exc
                break

    def stop(self, timeout: float | None = 5.0) -> None:
        """Stop the background loop (idempotent; safe before OR after the
        service closes).  ``tick()`` remains callable by hand afterwards."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout)

    close = stop

    def __enter__(self) -> "AdaptiveServeController":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def __repr__(self) -> str:
        return (f"AdaptiveServeController(slo_p99_ms="
                f"{self.config.slo_p99_ms}, ticks={self._ticks}, "
                f"adjustments={self._adjustments}, "
                f"converged={self.converged})")
