"""Bounded latency histograms for the serving statistics.

A numpy-only copy of the ``Reservoir`` of the reference package's
``repro/obs/metrics.py`` (that module imports no jax, but importing
anything of ``repro`` does).  ``ServiceStats`` keeps its latencies in it:
memory is O(#bins) however long a service runs, and quantiles carry a
documented relative error of at most ``sqrt(growth) - 1``.  The rest of
that module (``MetricsHub``, the snapshot emitter and its schema check)
comes with the telemetry hub, ROADMAP A8.
"""
from __future__ import annotations

import math
import threading

import numpy as np

# quantiles every histogram snapshot reports (p50 the median, p99 the SLO
# edge a controller steers on)
HISTOGRAM_QUANTILES = (50, 90, 95, 99)


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
