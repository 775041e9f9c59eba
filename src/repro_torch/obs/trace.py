"""LoadTrace: record/replay format for GraphServe traffic.

The port of the reference package's ``repro/obs/trace.py``: the same
format, and ``synthesize`` draws exactly as the reference does, so the
same arguments give a byte-identical file in both packages and each loads
the other's.

Policy changes (batching windows, fair-share weights, the adaptive
controller itself) must be judged against the SAME traffic, or the
comparison measures the load generator, not the policy.  A ``LoadTrace``
is that fixed traffic: a sorted sequence of arrival events, each an offset
from trace start plus the exact ``submit()`` arguments.

On-disk format — JSONL, one object per line:

    {"trace": 1, "meta": {"seed": 7, "qps": 40.0, ...}}   # optional header
    {"t": 0.0132, "app": "sssp", "params": {"source": 311, "max_iters": 64}}
    {"t": 0.0279, "app": "bfs",  "params": {"source": 19, "max_iters": 64}}

``t`` is seconds since trace start (non-negative; events are kept sorted).
``params`` is passed to ``GraphService.submit(app, **params)`` verbatim at
replay, so a trace replays bit-for-bit: same apps, same sources, same
iteration caps.  The committed mini-trace under ``benchmarks/traces/``
uses only *exact* app families (min-propagation sssp/bfs), so replayed
request results are bitwise identical run to run regardless of how the
policy happens to coalesce them (``tests/test_torch_trace.py`` pins
this).

``TraceRecorder`` captures live traffic (``serve/bench.py --record-trace``
hooks it into both the closed and open loop); ``LoadTrace.synthesize``
generates reproducible Poisson traffic with an optional mid-trace burst —
how the committed mini-trace was produced (generator committed with it).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from pathlib import Path

import numpy as np

TRACE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One arrival: ``t`` seconds after trace start, submit ``app, **params``."""

    t: float
    app: str
    params: dict

    def to_json(self) -> str:
        return json.dumps({"t": round(self.t, 6), "app": self.app,
                           "params": self.params}, sort_keys=True)


def _parse_event(obj: dict, where: str) -> TraceEvent:
    try:
        t = float(obj["t"])
        app = obj["app"]
        params = obj.get("params", {})
    except (KeyError, TypeError, ValueError):
        raise ValueError(f"{where}: malformed trace event {obj!r}") from None
    if t < 0 or not isinstance(app, str) or not isinstance(params, dict):
        raise ValueError(f"{where}: malformed trace event {obj!r}")
    return TraceEvent(t=t, app=app, params=params)


class LoadTrace:
    """An immutable, time-sorted sequence of ``TraceEvent``s plus metadata."""

    def __init__(self, events, meta: dict | None = None):
        self.events: tuple[TraceEvent, ...] = tuple(
            sorted(events, key=lambda e: e.t))
        self.meta: dict = dict(meta or {})

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def __getitem__(self, i):
        return self.events[i]

    @property
    def duration(self) -> float:
        return self.events[-1].t if self.events else 0.0

    def apps(self) -> dict:
        """{app: event count} — the traffic mix at a glance."""
        out: dict[str, int] = {}
        for e in self.events:
            out[e.app] = out.get(e.app, 0) + 1
        return dict(sorted(out.items()))

    def mean_qps(self) -> float:
        return len(self.events) / self.duration if self.duration > 0 else 0.0

    # -- persistence -----------------------------------------------------
    def save(self, path: str | os.PathLike) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            f.write(json.dumps({"trace": TRACE_VERSION, "meta": self.meta},
                               sort_keys=True) + "\n")
            for e in self.events:
                f.write(e.to_json() + "\n")
        return path

    @classmethod
    def load(cls, path: str | os.PathLike) -> "LoadTrace":
        path = Path(path)
        events, meta = [], {}
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                where = f"{path}:{lineno}"
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    raise ValueError(f"{where}: not JSON") from None
                if not isinstance(obj, dict):
                    raise ValueError(f"{where}: expected an object")
                if "trace" in obj:  # header line
                    if obj["trace"] != TRACE_VERSION:
                        raise ValueError(
                            f"{where}: unknown trace version "
                            f"{obj['trace']!r}")
                    meta = dict(obj.get("meta", {}))
                    continue
                events.append(_parse_event(obj, where))
        if not events:
            raise ValueError(f"{path}: trace has no events")
        return cls(events, meta)

    # -- synthesis -------------------------------------------------------
    @classmethod
    def synthesize(cls, *, duration_s: float, qps: float, mix: dict,
                   num_vertices: int, seed: int = 0, max_iters: int = 64,
                   params_by_app: dict | None = None,
                   burst: tuple | None = None) -> "LoadTrace":
        """Reproducible Poisson traffic: exponential inter-arrivals at
        ``qps``, apps drawn by ``mix`` weights, sources uniform over
        ``num_vertices`` (apps with a ``BatchSpec`` get the spec's source
        param; others run source-free).  ``burst=(start_s, end_s, factor)``
        multiplies the arrival rate inside that span — the regime change
        the adaptive controller has to ride out.  Same arguments, same
        trace, bit for bit (seeded ``RandomState``).
        """
        from repro_torch.core.apps import batch_spec

        if qps <= 0 or duration_s <= 0:
            raise ValueError("duration_s and qps must be > 0")
        if not mix or any(w <= 0 for w in mix.values()):
            raise ValueError(f"mix must map apps to positive weights: {mix!r}")
        rng = np.random.RandomState(seed)
        apps = sorted(mix)
        weights = np.asarray([mix[a] for a in apps], dtype=np.float64)
        weights /= weights.sum()
        params_by_app = params_by_app or {}
        events, t = [], 0.0
        while True:
            rate = qps
            if burst is not None and burst[0] <= t < burst[1]:
                rate = qps * burst[2]
            t += float(rng.exponential(1.0 / rate))
            if t >= duration_s:
                break
            app = apps[int(rng.choice(len(apps), p=weights))]
            params = dict(params_by_app.get(app, {}))
            params.setdefault("max_iters", max_iters)
            spec = batch_spec(app)
            if spec is not None and spec.source_param not in params:
                params[spec.source_param] = int(rng.randint(num_vertices))
            events.append(TraceEvent(t=t, app=app, params=params))
        meta = {"seed": seed, "qps": qps, "duration_s": duration_s,
                "mix": dict(sorted(mix.items())),
                "num_vertices": num_vertices, "max_iters": max_iters}
        if burst is not None:
            meta["burst"] = list(burst)
        return cls(events, meta)

    def __repr__(self) -> str:
        return (f"LoadTrace({len(self.events)} events, "
                f"{self.duration:.2f}s, apps={self.apps()})")


class TraceRecorder:
    """Thread-safe capture of live submissions into a ``LoadTrace``.

    ``record(app, params)`` stamps the event at now minus the first
    record's timestamp (so traces always start near 0); pass ``t=`` to
    record an *intended* arrival offset instead — the open-loop bench does
    this so the recorded trace is the schedule, not the schedule plus
    generator jitter.
    """

    def __init__(self, meta: dict | None = None, clock=time.perf_counter):
        self.meta = dict(meta or {})
        self._clock = clock
        self._lock = threading.Lock()
        self._t0: float | None = None
        self._events: list[TraceEvent] = []

    def record(self, app: str, params: dict, t: float | None = None) -> None:
        with self._lock:
            if t is None:
                now = self._clock()
                if self._t0 is None:
                    self._t0 = now
                t = now - self._t0
            self._events.append(TraceEvent(t=float(t), app=app,
                                           params=dict(params)))

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def trace(self) -> LoadTrace:
        with self._lock:
            return LoadTrace(self._events, self.meta)

    def save(self, path: str | os.PathLike) -> Path:
        return self.trace().save(path)
