"""GraphPulse telemetry: bounded metrics primitives + a structured emitter.

The port of the reference package's ``repro/obs/metrics.py`` (numpy and the
standard library only; that module imports no jax, but importing anything
of ``repro`` does, so this package keeps its own copy).  The snapshot v1
format is the reference's byte for byte: a file either package's hub
writes validates under the other's ``validate_file``.

* ``Reservoir`` — a bounded log-binned histogram with a documented
  percentile error (at most ``sqrt(growth) - 1``, < 1% at the default
  ``growth=1.02``).  Memory is O(#bins) however long a service runs, and
  quantiles can be computed over a counts *delta* — how the adaptive
  controller reads rolling-window percentiles.
* ``Counter`` / ``Gauge`` — a monotone total and a last-value-wins reading.
* ``MetricsHub`` — a named registry of counters, gauges and histograms,
  plus *pollers* (callables returning a dict, flattened into gauges at
  sample time — how ``cache_report()`` and ``ServiceStats`` feed the hub
  without double bookkeeping).  ``sample()`` takes one snapshot dict and
  keeps a bounded ring of them (``timeseries()``); with an emit path
  (``GRAPHMP_METRICS``) a daemon thread appends one JSON object per line
  every ``GRAPHMP_METRICS_INTERVAL`` seconds.
* ``validate_snapshot`` / ``validate_file`` / ``python -m repro_torch.obs
  FILE...`` — the snapshot schema, enforced.

Every structure is thread-safe: the hooks fire from client, runner and
pipeline threads at once.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import OrderedDict, deque
from pathlib import Path

import numpy as np

SNAPSHOT_VERSION = 1

# quantiles every histogram snapshot reports (p50 the median, p99 the SLO
# edge the controller steers on)
HISTOGRAM_QUANTILES = (50, 90, 95, 99)


class Counter:
    """Monotone counter (float-valued: byte totals and stall *seconds* are
    both counters).  ``inc`` with a negative amount is a programming error."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters are monotone; inc({amount!r})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-value-wins instantaneous measurement (queue depth, hit ratio)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Reservoir:
    """Bounded log-binned histogram with a documented quantile error.

    Bin layout (``nbins + 2`` int64 counts, ~10 KB at the defaults):

    * bin 0: values ``<= min_value`` (including zero and negatives) —
      reported as ``min_value`` exactly, so the *absolute* error down there
      is at most ``min_value``;
    * bin ``i`` in ``1..nbins``: ``(min_value * g^(i-1), min_value * g^i]``
      — reported as the geometric midpoint ``min_value * g^(i-0.5)``, so
      the *relative* error is at most ``sqrt(g) - 1`` (< 1% at the default
      ``growth = 1.02``);
    * the last bin catches values ``> max_value`` (reported as
      ``max_value`` — a clamp, not an estimate).

    ``quantile(q)`` locates the bin containing the ceil(q/100 * N)-th
    smallest observation — the same nearest-rank definition the serving
    stats always used — in O(#bins).  ``count``/``sum``/``min``/``max``
    are tracked exactly.  ``quantile(q, counts=...)`` evaluates an
    arbitrary counts vector with this reservoir's bin geometry: subtract
    two ``counts()`` snapshots and you have an exact rolling-window
    percentile without any extra recording machinery.
    """

    def __init__(self, min_value: float = 1e-6, max_value: float = 1e5,
                 growth: float = 1.02):
        if not (0 < min_value < max_value):
            raise ValueError(
                f"need 0 < min_value < max_value, got {min_value!r}, "
                f"{max_value!r}")
        if not growth > 1.0:
            raise ValueError(f"growth must be > 1, got {growth!r}")
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self.nbins = int(math.ceil(
            math.log(self.max_value / self.min_value) / self._log_g))
        self._lock = threading.Lock()
        self._counts = np.zeros(self.nbins + 2, dtype=np.int64)
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- recording -------------------------------------------------------
    def _index(self, value: float) -> int:
        if value <= self.min_value:
            return 0
        if value > self.max_value:
            return self.nbins + 1
        # value in (min * g^(i-1), min * g^i]  =>  i = ceil(log_g(v/min))
        i = int(math.ceil(math.log(value / self.min_value) / self._log_g
                          - 1e-12))
        return min(max(i, 1), self.nbins)

    def observe(self, value: float) -> None:
        value = float(value)
        idx = self._index(value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._min = min(self._min, value)
            self._max = max(self._max, value)

    # -- reading ---------------------------------------------------------
    @property
    def count(self) -> int:
        with self._lock:
            return int(self._counts.sum())

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def min(self) -> float:
        with self._lock:
            return self._min if math.isfinite(self._min) else 0.0

    @property
    def max(self) -> float:
        with self._lock:
            return self._max if math.isfinite(self._max) else 0.0

    @property
    def mean(self) -> float:
        with self._lock:
            n = int(self._counts.sum())
            return self._sum / n if n else 0.0

    def counts(self) -> np.ndarray:
        """Consistent copy of the bin counts (subtract two snapshots for a
        rolling window; pass the difference back to ``quantile``)."""
        with self._lock:
            return self._counts.copy()

    def _bin_value(self, idx: int) -> float:
        if idx <= 0:
            return self.min_value
        if idx >= self.nbins + 1:
            return self.max_value
        return self.min_value * self.growth ** (idx - 0.5)

    def quantile(self, q: float, counts: np.ndarray | None = None) -> float:
        """Nearest-rank quantile (bin-midpoint estimate, error documented in
        the class docstring).  ``counts`` overrides the live counts — pass a
        snapshot delta for a windowed percentile.  Empty data -> 0.0."""
        if not 0 < q <= 100:
            raise ValueError(f"quantile q must be in (0, 100], got {q!r}")
        if counts is None:
            counts = self.counts()
        n = int(counts.sum())
        if n <= 0:
            return 0.0
        rank = math.ceil(q / 100.0 * n)  # 1-based nearest rank
        cum = 0
        for idx, c in enumerate(counts):
            cum += int(c)
            if cum >= rank:
                return self._bin_value(idx)
        return self._bin_value(len(counts) - 1)  # unreachable

    def to_dict(self, scale: float = 1.0) -> dict:
        """One snapshot dict (``scale`` converts units, e.g. 1e3 for
        seconds -> milliseconds in the emitted metric)."""
        with self._lock:
            counts = self._counts.copy()
            total = int(counts.sum())
            s = self._sum
            lo = self._min if math.isfinite(self._min) else 0.0
            hi = self._max if math.isfinite(self._max) else 0.0
        out = {
            "count": total,
            "sum": s * scale,
            "min": lo * scale,
            "max": hi * scale,
            "mean": (s / total if total else 0.0) * scale,
        }
        for q in HISTOGRAM_QUANTILES:
            out[f"p{q}"] = self.quantile(q, counts=counts) * scale
        return out


class MetricsHub:
    """Named registry of counters/gauges/histograms + snapshot emitter.

    ``counter(name)`` / ``gauge(name)`` / ``histogram(name)`` get-or-create
    by name (first caller fixes a histogram's bin geometry);
    ``adopt_histogram(name, reservoir)`` registers an *existing* Reservoir
    so a producer (``ServiceStats``) and the hub share ONE bounded
    structure instead of recording twice.  ``register_poller(prefix, fn)``
    attaches a callable returning a (possibly nested) dict; at ``sample()``
    time its numeric leaves become gauges named ``prefix.key`` — how
    ``cache.report()`` and service queue depths enter snapshots without
    hub-aware call sites.

    ``sample()`` returns the snapshot dict, appends it to a bounded ring
    (``retain``), and — when constructed with ``emit_path`` (default: env
    ``GRAPHMP_METRICS``; empty/unset disables) — is called periodically by
    a daemon thread (``emit_interval``, env ``GRAPHMP_METRICS_INTERVAL``,
    default 1.0 s) that appends one JSON line per sample.  ``close()``
    stops the thread and emits one final snapshot, and is idempotent;
    after it, recording calls still work (cheap, in-memory) but nothing
    more is written.

    ``timeseries(name)`` reads the retained ring: a list of ``(t, value)``
    for a counter/gauge name, or ``(t, dict)`` for a histogram.  ``t`` is
    seconds since the hub started (monotonic clock), so emitted files from
    repeated runs line up at 0.
    """

    def __init__(self, emit_path: str | os.PathLike | None = None, *,
                 emit_interval: float | None = None, retain: int = 1024,
                 clock=time.monotonic):
        if emit_path is None:
            emit_path = os.environ.get("GRAPHMP_METRICS") or None
        if emit_interval is None:
            try:
                emit_interval = float(
                    os.environ.get("GRAPHMP_METRICS_INTERVAL", "") or 1.0)
            except ValueError:
                emit_interval = 1.0
        self.emit_path = Path(emit_path) if emit_path else None
        self.emit_interval = max(float(emit_interval), 0.05)
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.RLock()
        self._counters: OrderedDict[str, Counter] = OrderedDict()
        self._gauges: OrderedDict[str, Gauge] = OrderedDict()
        self._histograms: OrderedDict[str, Reservoir] = OrderedDict()
        self._pollers: OrderedDict[str, object] = OrderedDict()
        self._ring: deque[dict] = deque(maxlen=max(int(retain), 1))
        self._file = None
        self._closed = False
        self._stop = threading.Event()
        self._thread = None
        if self.emit_path is not None:
            self.emit_path.parent.mkdir(parents=True, exist_ok=True)
            self._file = open(self.emit_path, "a", buffering=1)
            self._thread = threading.Thread(
                target=self._emit_loop, name="graphpulse-emit", daemon=True)
            self._thread.start()

    # -- registry --------------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str, **reservoir_kwargs) -> Reservoir:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Reservoir(**reservoir_kwargs)
            return h

    def adopt_histogram(self, name: str, reservoir: Reservoir) -> Reservoir:
        """Register an existing Reservoir under ``name`` (shared-structure
        wiring; replaces any previous registration)."""
        with self._lock:
            self._histograms[name] = reservoir
            return reservoir

    def register_poller(self, prefix: str, fn) -> None:
        """``fn() -> dict``; numeric leaves appear as gauges ``prefix.key``
        (nested dicts flatten with dots, non-numeric leaves are skipped)."""
        with self._lock:
            self._pollers[prefix] = fn

    def unregister_poller(self, prefix: str) -> None:
        with self._lock:
            self._pollers.pop(prefix, None)

    # -- snapshots -------------------------------------------------------
    @staticmethod
    def _flatten(prefix: str, obj, out: dict) -> None:
        if isinstance(obj, dict):
            for k, v in obj.items():
                MetricsHub._flatten(f"{prefix}.{k}", v, out)
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                MetricsHub._flatten(f"{prefix}.{i}", v, out)
        elif isinstance(obj, bool):
            out[prefix] = float(obj)
        elif isinstance(obj, (int, float, np.integer, np.floating)):
            v = float(obj)
            if math.isfinite(v):
                out[prefix] = v
        # strings and other leaves are labels, not metrics: skipped

    def sample(self) -> dict:
        """Take one snapshot: run pollers, read every metric, append to the
        retained ring, and return the dict (callers may emit or inspect)."""
        with self._lock:
            pollers = list(self._pollers.items())
            counters = {n: c.value for n, c in self._counters.items()}
            gauges = {n: g.value for n, g in self._gauges.items()}
            hists = {n: h.to_dict() for n, h in self._histograms.items()}
        for prefix, fn in pollers:
            try:
                polled = fn()
            except Exception:
                continue  # a dead poller must not kill the emitter
            if isinstance(polled, dict):
                self._flatten(prefix, polled, gauges)
        snap = {
            "v": SNAPSHOT_VERSION,
            "t": round(self._clock() - self._t0, 6),
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
        }
        with self._lock:
            self._ring.append(snap)
        return snap

    def timeseries(self, name: str) -> list[tuple]:
        """``[(t, value), ...]`` for a metric across retained snapshots
        (counters and gauges yield floats; histograms yield their snapshot
        dicts; unknown names yield an empty list)."""
        with self._lock:
            snaps = list(self._ring)
        out = []
        for s in snaps:
            for section in ("gauges", "counters", "histograms"):
                if name in s[section]:
                    out.append((s["t"], s[section][name]))
                    break
        return out

    @property
    def snapshots(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    # -- emission --------------------------------------------------------
    def emit(self, snapshot: dict | None = None) -> None:
        """Append one snapshot as a JSON line (no-op without an emit path
        or after close)."""
        if snapshot is None:
            snapshot = self.sample()
        with self._lock:
            if self._file is None or self._closed:
                return
            self._file.write(json.dumps(snapshot, sort_keys=True) + "\n")

    def _emit_loop(self) -> None:
        while not self._stop.wait(self.emit_interval):
            self.emit()

    def close(self) -> None:
        """Stop the emitter and flush a final snapshot.  Idempotent; the
        in-memory registry keeps working afterwards."""
        with self._lock:
            if self._closed:
                return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._file is not None:
            self.emit()  # final snapshot: a run's last state always lands
        with self._lock:
            self._closed = True
            if self._file is not None:
                self._file.close()
                self._file = None

    def __enter__(self) -> "MetricsHub":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# schema validation (every emitted file is checked against it)
# ---------------------------------------------------------------------------
_HIST_REQUIRED = ("count", "sum", "min", "max", "mean") + tuple(
    f"p{q}" for q in HISTOGRAM_QUANTILES)


def _require_number(value, what: str) -> float:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        raise ValueError(f"{what} must be a number, got {value!r}")
    if not math.isfinite(value):
        raise ValueError(f"{what} must be finite, got {value!r}")
    return float(value)


def validate_snapshot(obj) -> None:
    """Raise ``ValueError`` unless ``obj`` is a well-formed v1 snapshot:
    ``v == 1``, ``t`` a finite number >= 0, ``counters``/``gauges`` dicts of
    finite numbers (counters >= 0), ``histograms`` a dict of dicts carrying
    ``count``/``sum``/``min``/``max``/``mean``/``p50``/``p90``/``p95``/
    ``p99`` with a non-negative integer count."""
    if not isinstance(obj, dict):
        raise ValueError(f"snapshot must be a dict, got {type(obj).__name__}")
    if obj.get("v") != SNAPSHOT_VERSION:
        raise ValueError(f"unknown snapshot version {obj.get('v')!r}")
    if _require_number(obj.get("t"), "t") < 0:
        raise ValueError(f"t must be >= 0, got {obj['t']!r}")
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(obj.get(section), dict):
            raise ValueError(f"missing/invalid section {section!r}")
    for name, value in obj["counters"].items():
        if _require_number(value, f"counter {name!r}") < 0:
            raise ValueError(f"counter {name!r} is negative: {value!r}")
    for name, value in obj["gauges"].items():
        _require_number(value, f"gauge {name!r}")
    for name, hist in obj["histograms"].items():
        if not isinstance(hist, dict):
            raise ValueError(f"histogram {name!r} must be a dict")
        for field in _HIST_REQUIRED:
            if field not in hist:
                raise ValueError(f"histogram {name!r} missing {field!r}")
            _require_number(hist[field], f"histogram {name!r}.{field}")
        count = hist["count"]
        if not isinstance(count, int) or isinstance(count, bool) or count < 0:
            raise ValueError(
                f"histogram {name!r}.count must be an int >= 0, got "
                f"{count!r}")


def validate_file(path: str | os.PathLike) -> int:
    """Validate every line of a metrics JSONL file; returns the number of
    snapshots, raises ``ValueError`` (with the line number) on the first
    malformed one.  Zero lines is an error: an 'emitting' run must emit."""
    count = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                validate_snapshot(obj)
            except ValueError as exc:
                raise ValueError(f"{path}:{lineno}: {exc}") from None
            count += 1
    if count == 0:
        raise ValueError(f"{path}: no snapshots emitted")
    return count


def main(argv=None) -> int:
    """``python -m repro_torch.obs FILE...`` — schema-check metrics JSONL
    files (what ``chip_smoke.py`` runs on the replay's emissions)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Validate GraphPulse metrics JSONL files")
    ap.add_argument("files", nargs="+", help="metrics .jsonl files to check")
    args = ap.parse_args(argv)
    for path in args.files:
        try:
            n = validate_file(path)
        except (OSError, ValueError) as exc:
            print(f"FAIL {exc}")
            return 1
        print(f"ok {path}: {n} snapshots")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
