"""GraphService: concurrent graph-query serving with dynamic micro-batching.

The port of the reference package's ``repro/serve/graph_service.py``, over
this package's ``GraphSession`` and app registry; the batching, admission,
memoization and shutdown behaviour is the reference's.

Query-centric systems (Yan et al.'s "quegel" point-query model, NXgraph)
show that a serving workload is many concurrent POINT queries, not one
batch job.  ``GraphSession.run_batch`` answers K compatible queries for
roughly ONE sweep of disk I/O and host-to-device staging — this module
turns an arbitrary stream of independent client requests into those
K-column sweeps:

    client threads --submit()--> pending queue --coalesce--> run_batch
         ^                                                      |
         +-- future.result()  <--- per-column RunResult --------+

* ``submit("sssp", source=7)`` returns a ``concurrent.futures.Future``
  immediately; many client threads may submit concurrently.
* A dispatcher thread groups compatible pending requests — same
  ``BatchSpec.family`` (app family + semiring) and identical non-source
  parameters — into micro-batches of up to ``max_batch`` columns, waiting
  at most ``max_wait_ms`` for stragglers (classic dynamic batching).
* Batches execute on a runner pool (``max_inflight`` concurrent sweeps)
  against ONE shared ``GraphSession`` — one compressed cache, engines
  shared by ``jit_signature`` so a stream of distinct source sets reuses
  one engine per K.
* Non-batchable apps (global pagerank, cc) coalesce by exact identity:
  duplicate in-flight requests share a single engine run.
* A small memo layer keyed on (app, params, graph token — the store's
  epoch for mutable graphs, mtime for frozen ones) serves repeated hot
  queries (popular PPR seeds) without any sweep at all.
* ``apply_mutations`` pauses dispatch, drains in-flight sweeps, commits
  through ``session.apply_mutations`` (the session must be
  ``mutable=True``) and refreshes memoized incremental results through
  ``session.run_incremental``.

Batch padding: groups are padded up to the next power of two (duplicating
the last source) so the [n, K] engines number O(log max_batch) distinct K
values instead of every group size the traffic happens to produce; padded
columns are dropped before resolution.

Exactness: min-propagation families (sssp/bfs) resolve futures bitwise
identical to a solo ``session.run`` of the same query regardless of
batching (the semiring ops are exact and column-independent).  plus_src
(ppr) matches its solo K=1 form to float tolerance (``BatchSpec.exact``).
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import Counter, OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from math import ceil

from repro_torch.core.apps import batch_spec, is_incremental, list_apps
from repro_torch.graph.source import graph_token
from repro_torch.obs.metrics import Reservoir


class ServiceClosed(RuntimeError):
    """submit() after close(): the service no longer accepts work."""


@dataclasses.dataclass(frozen=True)
class MutationReport:
    """What ``GraphService.apply_mutations`` did to the serving state."""

    epoch: int           # graph epoch after the commit
    memo_refreshed: int  # memo entries recomputed incrementally and re-keyed
    memo_dropped: int    # memo entries invalidated outright


class AdmissionError(RuntimeError):
    """Request refused by admission control (queue full / app not served)."""


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Batching / admission policy for a GraphService.

    max_batch:
        Column cap per micro-batch (K of the underlying ``run_batch``).
    max_wait_ms:
        How long the dispatcher holds a partially-filled batch open for
        stragglers, measured from the OLDEST pending request.  0 disables
        waiting: every dispatch takes whatever is queued right now
        (latency-optimal, occupancy-pessimal).
    max_inflight:
        Concurrent sweeps on the runner pool.  1 serializes all engine work
        (often right on small machines — sweeps are already parallel
        internally); >1 lets independent families overlap.
    max_queue:
        Admission bound on pending (not yet dispatched) requests; submit()
        raises AdmissionError beyond it instead of growing an unbounded
        backlog.
    apps:
        Per-app admission allowlist; None serves every registered app plus
        the batch-only names ("ppr").
    memoize / memo_capacity / memo_budget_bytes:
        Result memoization keyed on (app, params, graph token): repeated hot
        queries skip the sweep entirely.  LRU-bounded at ``memo_capacity``
        entries AND ``memo_budget_bytes`` of result values (each entry holds
        a full length-n vector, so the byte bound is the one that matters on
        big graphs; a result larger than the whole budget is simply not
        memoized).  Results are shared objects — callers must treat them as
        read-only.
    pad_batches:
        Pad groups to the next power of two (see module docstring); disable
        only to measure the recompile cost it avoids.
    max_iters:
        Default iteration cap applied when a request does not pass its own
        ``max_iters``.
    fair_weights:
        Per-app weights for the dispatcher's stride fair-share scheduler
        (dict or pair-iterable; normalized to a sorted tuple).  Each
        dispatched request charges its app ``1/weight`` of virtual time and
        the dispatcher serves the READY group whose app is furthest behind
        — so a flood of cheap BFS queries cannot starve a pending PPR
        group past its wait deadline.  Unlisted apps weigh 1.0; None means
        everyone weighs 1.0 (pure round-robin among ready groups).

    ``max_batch``, ``max_wait_ms``, ``max_queue``, ``max_iters`` and
    ``fair_weights`` are live-tunable via ``GraphService.reconfigure``
    (the adaptive controller's write path); the rest are fixed at
    construction (``max_inflight`` sizes a real thread pool).
    """

    max_batch: int = 16
    max_wait_ms: float = 2.0
    max_inflight: int = 2
    max_queue: int = 1024
    apps: tuple | None = None
    memoize: bool = True
    memo_capacity: int = 256
    memo_budget_bytes: int = 1 << 28
    pad_batches: bool = True
    max_iters: int = 200
    fair_weights: tuple | None = None

    def __post_init__(self):
        if not isinstance(self.max_batch, int) or self.max_batch < 1:
            raise ValueError(f"max_batch must be an int >= 1, got "
                             f"{self.max_batch!r}")
        if not isinstance(self.max_wait_ms, (int, float)) \
                or self.max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got "
                             f"{self.max_wait_ms!r}")
        if not isinstance(self.max_inflight, int) or self.max_inflight < 1:
            raise ValueError(f"max_inflight must be an int >= 1, got "
                             f"{self.max_inflight!r}")
        if not isinstance(self.max_queue, int) or self.max_queue < 1:
            raise ValueError(f"max_queue must be an int >= 1, got "
                             f"{self.max_queue!r}")
        if self.apps is not None:
            object.__setattr__(self, "apps", tuple(self.apps))
        if not isinstance(self.memo_capacity, int) or self.memo_capacity < 0:
            raise ValueError(f"memo_capacity must be an int >= 0, got "
                             f"{self.memo_capacity!r}")
        if not isinstance(self.memo_budget_bytes, int) \
                or self.memo_budget_bytes < 0:
            raise ValueError(f"memo_budget_bytes must be an int >= 0, got "
                             f"{self.memo_budget_bytes!r}")
        if not isinstance(self.max_iters, int) or self.max_iters < 1:
            raise ValueError(f"max_iters must be an int >= 1, got "
                             f"{self.max_iters!r}")
        if self.fair_weights is not None:
            items = (self.fair_weights.items()
                     if isinstance(self.fair_weights, dict)
                     else self.fair_weights)
            norm = tuple(sorted((str(app), float(w)) for app, w in items))
            if any(w <= 0 for _, w in norm):
                raise ValueError(f"fair_weights must be > 0, got "
                                 f"{self.fair_weights!r}")
            object.__setattr__(self, "fair_weights", norm)

    def weight_for(self, app: str) -> float:
        """Fair-share weight of ``app`` (1.0 unless listed)."""
        if self.fair_weights is not None:
            for name, w in self.fair_weights:
                if name == app:
                    return w
        return 1.0

    def replace(self, **changes) -> "ServiceConfig":
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# statistics
# ---------------------------------------------------------------------------
def _nearest_rank(ordered, q: float) -> float:
    """The ceil(q/100 * N)-th smallest of an ALREADY-SORTED sequence."""
    if not ordered:
        return 0.0
    return float(ordered[ceil(q / 100.0 * len(ordered)) - 1])


def percentile(values, q: float) -> float:
    """Nearest-rank percentile: the ceil(q/100 * N)-th smallest value.

    Deliberately NOT an interpolating estimator — every reported latency is
    a latency some request actually saw.
    """
    if not 0 < q <= 100:
        raise ValueError(f"percentile q must be in (0, 100], got {q!r}")
    return _nearest_rank(sorted(values), q)


class ServiceStats:
    """Thread-safe serving counters + latency/occupancy distributions.

    ``snapshot()`` returns one self-consistent dict: request counts
    (submitted/completed/memo_hits/rejected/failed), current and peak queue
    depth, p50/p95/p99/mean latency in milliseconds, the batch-occupancy
    histogram {K: batches executed with K live columns}, and
    ``cache_served_fraction`` (memo hits over completed requests).

    Latencies live in bounded log-binned reservoirs
    (``repro_torch.obs.metrics.Reservoir``) — one overall
    (``latency_hist``) plus one per app, created lazily — NOT an ordered
    list: memory is O(#bins) however long the service runs, percentile
    reads are O(#bins) however much traffic arrived, and bin-count
    snapshots subtract, giving rolling-window percentiles for free.  The
    cost is a documented ~1% relative error on quantiles (see
    ``Reservoir``; mean stays exact via sum/count).  Counters are lifetime
    totals.

    ``attach_hub`` shares these same reservoirs with a ``MetricsHub`` (no
    double recording) and registers a poller exporting the counters, so
    every snapshot the hub emits carries the serving state.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # seconds per completed request: one overall + one per app, all
        # bounded reservoirs shared with any attached MetricsHub
        self.latency_hist = Reservoir()
        self._app_hists: dict[str, Reservoir] = {}
        self.batch_occupancy: Counter = Counter()
        self.submitted = 0
        self.completed = 0
        self.memo_hits = 0
        self.rejected = 0
        self.failed = 0
        self.queue_depth = 0
        self.queue_peak = 0
        self._hub = None
        self._hub_prefix = "serve"

    # -- recording hooks (service-internal) -----------------------------
    def record_submitted(self, queue_depth: int) -> None:
        with self._lock:
            self.submitted += 1
            self.queue_depth = queue_depth
            self.queue_peak = max(self.queue_peak, queue_depth)

    def record_dequeued(self, queue_depth: int) -> None:
        with self._lock:
            self.queue_depth = queue_depth

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_batch(self, occupancy: int) -> None:
        with self._lock:
            self.batch_occupancy[occupancy] += 1

    def record_latency(self, seconds: float, memo_hit: bool = False,
                       app: str | None = None) -> None:
        self.latency_hist.observe(seconds)
        if app is not None:
            self._app_hist(app).observe(seconds)
        with self._lock:
            self.completed += 1
            self.memo_hits += int(memo_hit)

    def record_failed(self, count: int = 1) -> None:
        with self._lock:
            self.failed += count

    def _app_hist(self, app: str) -> Reservoir:
        with self._lock:
            h = self._app_hists.get(app)
            if h is None:
                h = self._app_hists[app] = Reservoir()
                if self._hub is not None:
                    self._hub.adopt_histogram(
                        f"{self._hub_prefix}.latency_s.{app}", h)
            return h

    # -- telemetry wiring -------------------------------------------------
    def attach_hub(self, hub, prefix: str = "serve") -> None:
        """Share the latency reservoirs with ``hub`` (adopted, not copied)
        and export the counters as a poller named ``prefix``."""
        with self._lock:
            self._hub = hub
            self._hub_prefix = prefix
            hub.adopt_histogram(f"{prefix}.latency_s", self.latency_hist)
            for app, h in self._app_hists.items():
                hub.adopt_histogram(f"{prefix}.latency_s.{app}", h)
        hub.register_poller(prefix, self._poll)

    def _poll(self) -> dict:
        with self._lock:
            occ = dict(self.batch_occupancy)
            out = dict(
                submitted=self.submitted, completed=self.completed,
                memo_hits=self.memo_hits, rejected=self.rejected,
                failed=self.failed, queue_depth=self.queue_depth,
                queue_peak=self.queue_peak,
            )
        batches = sum(occ.values())
        out["batches"] = batches
        out["mean_occupancy"] = (sum(k * v for k, v in occ.items()) / batches
                                 if batches else 0.0)
        return out

    # -- reading ---------------------------------------------------------
    def occupancy(self) -> dict:
        """Copy of the {K: batch count} occupancy histogram (the adaptive
        controller diffs successive copies for per-window occupancy)."""
        with self._lock:
            return dict(self.batch_occupancy)

    def latency_ms(self, q: float) -> float:
        return self.latency_hist.quantile(q) * 1e3

    def snapshot(self) -> dict:
        with self._lock:
            occ = dict(sorted(self.batch_occupancy.items()))
            completed, memo = self.completed, self.memo_hits
            snap = dict(
                submitted=self.submitted, completed=completed,
                memo_hits=memo, rejected=self.rejected, failed=self.failed,
                queue_depth=self.queue_depth, queue_peak=self.queue_peak,
            )
        hist = self.latency_hist.to_dict(scale=1e3)
        snap.update(
            p50_ms=hist["p50"], p95_ms=hist["p95"], p99_ms=hist["p99"],
            mean_ms=hist["mean"],
            batch_occupancy=occ,
            cache_served_fraction=memo / completed if completed else 0.0,
        )
        return snap


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Request:
    app: str
    params: dict            # full request params minus the source (if batched)
    source: int | None      # frontier vertex for batchable apps
    group_key: tuple        # requests with equal keys may share one execution
    memo_key: tuple | None
    future: Future
    t_submit: float         # time.perf_counter() at admission


def _params_key(params: dict) -> tuple:
    return tuple(sorted(params.items()))


def _next_pow2(k: int) -> int:
    return 1 << (k - 1).bit_length()


class GraphService:
    """Thread-safe concurrent query service over ONE shared GraphSession.

    See the module docstring for the architecture.  Lifecycle::

        svc = session.service(max_batch=16)      # started on construction
        futs = [svc.submit("sssp", source=s) for s in sources]
        dists = [f.result().values for f in futs]
        svc.close()                              # drains pending work

    or as a context manager (``with session.service() as svc:``).
    """

    def __init__(self, session, config: ServiceConfig | None = None,
                 **overrides):
        if config is None:
            config = ServiceConfig(**overrides)
        elif overrides:
            config = config.replace(**overrides)
        self.session = session
        self.config = config
        self.stats = ServiceStats()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: deque[_Request] = deque()
        # per-group pending counts, maintained on every append/pop: the
        # dispatcher's wait loop and full-group lookup stay O(#groups),
        # not O(queue length), under the lock submit() contends on
        self._pending_counts: Counter = Counter()
        # stride fair-share state (dispatcher-side, guarded by _cond): per-
        # app pass values + the virtual time new apps join at
        self._app_pass: dict[str, float] = {}
        self._vtime = 0.0
        self._closing = False
        self._closed = False
        # mutation barrier: while True the dispatcher launches no new
        # batches (apply_mutations also holds every inflight permit, so the
        # graph only changes between sweeps, never under one)
        self._paused = False
        self._mutate_lock = threading.Lock()  # serializes apply_mutations
        self._memo: OrderedDict = OrderedDict()  # key -> (result, nbytes)
        self._memo_bytes = 0
        self._graph_token = self._compute_graph_token(session.store)
        self._inflight = threading.Semaphore(config.max_inflight)
        self._runners = ThreadPoolExecutor(
            max_workers=config.max_inflight, thread_name_prefix="graphserve")
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="graphserve-dispatch", daemon=True)
        self._dispatcher.start()

    # ------------------------------------------------------------------
    @staticmethod
    def _compute_graph_token(store) -> tuple:
        """Identity of the graph snapshot for memo keys: a mutated, re-packed
        or re-preprocessed graph at the same path must not serve stale
        results.  Mutable stores version themselves with their epoch; frozen
        stores keep the historical mtime probe (see ``graph_token``)."""
        return graph_token(store)

    def _served_apps(self) -> tuple:
        if self.config.apps is not None:
            return self.config.apps
        # registry-derived (no hard-coded names): every registered factory
        # plus the batch-only serving aliases ("ppr", "lp", ...) list_apps
        # reports from the BatchSpec table
        return tuple(info.name for info in list_apps())

    # ------------------------------------------------------------------
    def submit(self, app: str, **params) -> Future:
        """Queue one query; returns a future resolving to its RunResult.

        ``app`` is any name ``list_apps()`` reports: a single-query app
        (``"sssp"``, ``"bfs"``, ``"cc"``, ``"pagerank"``,
        ``"label_propagation"``, ``"kcore"``, the ``"triangles"`` driver,
        ...) or a batch-only name (``"ppr"``, ``"lp"``,
        ``"triangle_count"``, ``"random_walk"``).  Names with a
        ``BatchSpec`` coalesce into one ``run_batch`` sweep: sssp/bfs/lp by
        ``source=``, ppr by ``seed=``, kcore by its threshold ``k=``,
        triangle_count by ``vertex=``, random_walk by ``source=`` (walks
        run on the host).  ``params`` are the factory arguments
        (``source=``, ``seed=``, ``damping=``, ``length=``...) plus an
        optional ``max_iters``.  Raises
        ``ServiceClosed`` after ``close()`` and ``AdmissionError`` when the
        pending queue is at ``max_queue`` or ``app`` is not served.
        """
        t0 = time.perf_counter()
        spec = batch_spec(app)
        if app not in self._served_apps():
            self.stats.record_rejected()
            raise AdmissionError(
                f"app {app!r} is not served here (serving "
                f"{self._served_apps()})")
        params = dict(params)
        params.setdefault("max_iters", self.config.max_iters)
        source = None
        if spec is not None:
            if spec.source_param not in params:
                raise TypeError(
                    f"{app!r} needs {spec.source_param}=<vertex id>")
            source = int(params.pop(spec.source_param))
            if source < 0:
                raise ValueError(
                    f"{spec.source_param} must be >= 0, got {source}")
            group_key = ("batch", spec.family, _params_key(params))
            memo_key = (app, source, _params_key(params), self._graph_token)
        else:
            group_key = ("solo", app, _params_key(params))
            memo_key = (app, None, _params_key(params), self._graph_token)
        if not self.config.memoize:
            memo_key = None

        future: Future = Future()
        with self._cond:
            if self._closing:
                raise ServiceClosed("GraphService is closed")
            if memo_key is not None:
                hit = self._memo.get(memo_key)
                if hit is not None:
                    self._memo.move_to_end(memo_key)
                    future.set_result(hit[0])
                    self.stats.record_submitted(len(self._pending))
                    self.stats.record_latency(time.perf_counter() - t0,
                                              memo_hit=True, app=app)
                    return future
            if len(self._pending) >= self.config.max_queue:
                self.stats.record_rejected()
                raise AdmissionError(
                    f"pending queue full ({self.config.max_queue} requests);"
                    " retry later")
            req = _Request(app=app, params=params, source=source,
                           group_key=group_key, memo_key=memo_key,
                           future=future, t_submit=t0)
            self._pending.append(req)
            self._pending_counts[group_key] += 1
            self.stats.record_submitted(len(self._pending))
            self._cond.notify_all()
        return future

    def submit_many(self, queries) -> list[Future]:
        """``submit`` for an iterable of ``(app, params_dict)`` pairs."""
        return [self.submit(app, **params) for app, params in queries]

    # ------------------------------------------------------------------
    def _dispatch_loop(self) -> None:
        # NOTE: self.config is re-read every pass (reconfigure() swaps the
        # frozen config object and notifies) — never cached across waits
        while True:
            with self._cond:
                # a mutation barrier (_paused) parks the dispatcher even
                # while closing — apply_mutations always lifts it in finally
                while self._paused or (not self._closing
                                       and not self._pending):
                    self._cond.wait()
                if not self._pending:
                    return  # closing and drained
                cfg = self.config
                now = time.perf_counter()
                key = self._ready_group(cfg, now)
                if key is None:
                    # no group is full or past its straggler deadline: sleep
                    # until the earliest deadline (or a submit/reconfigure/
                    # close notification), then re-evaluate from scratch
                    deadline = self._earliest_deadline(cfg)
                    self._cond.wait(None if deadline is None
                                    else max(deadline - now, 0.0))
                    continue
                group = self._take_group(key, cfg)
                self.stats.record_dequeued(len(self._pending))
            if not group:
                continue
            # bounded in-flight sweeps: acquiring here (dispatcher thread)
            # applies backpressure — the queue keeps admitting up to
            # max_queue while every runner is busy
            self._inflight.acquire()
            try:
                self._runners.submit(self._run_group, group)
            except BaseException:
                self._inflight.release()
                for r in group:
                    r.future.set_exception(ServiceClosed(
                        "runner pool rejected the batch"))
                if self._closing:
                    return
                raise

    def _group_heads(self) -> dict:
        """{group_key: oldest pending request} in one queue scan (the queue
        is FIFO, so the first request seen per key is its oldest)."""
        heads: dict[tuple, _Request] = {}
        for r in self._pending:
            if r.group_key not in heads:
                heads[r.group_key] = r
        return heads

    def _ready_group(self, cfg: ServiceConfig, now: float) -> tuple | None:
        """The group to dispatch now, or None to keep waiting.

        A group is READY when it is full (max_batch pending), its oldest
        request has waited max_wait_ms, or the service is closing (drain).
        Among ready groups the pick is weighted fair-share, not FIFO: each
        app carries a stride-scheduling pass value (advanced 1/weight per
        dispatched request), and the ready group whose app is furthest
        behind wins.  A flood of cheap BFS queries therefore keeps filling
        batches — but every time it dispatches its pass advances, so a
        ready PPR group's older pass takes the next slot: bounded bypass
        instead of starvation (the old policy dispatched ANY full group
        ahead of an expired head, indefinitely under flood).
        """
        best_key, best_pass = None, None
        for key, head in self._group_heads().items():
            ready = (self._closing
                     or self._pending_counts[key] >= cfg.max_batch
                     or now >= head.t_submit + cfg.max_wait_ms / 1e3)
            if not ready:
                continue
            app_pass = self._app_pass.get(head.app, self._vtime)
            if best_pass is None or app_pass < best_pass:
                best_key, best_pass = key, app_pass
        if best_key is not None:
            # advance virtual time to the winner so newly-seen apps start
            # here, not at 0 (no retroactive credit for late arrivals)
            self._vtime = max(self._vtime, best_pass)
        return best_key

    def _earliest_deadline(self, cfg: ServiceConfig) -> float | None:
        heads = self._group_heads()
        if not heads:
            return None
        return min(h.t_submit for h in heads.values()) + cfg.max_wait_ms / 1e3

    def _take_group(self, key: tuple, cfg: ServiceConfig) -> list[_Request]:
        """Pop up to max_batch requests sharing ``key`` (queue order) and
        charge their apps' fair-share passes.

        Marks each taken future running (``set_running_or_notify_cancel``),
        which both drops client-cancelled requests and makes the later
        ``set_result`` race-free against ``Future.cancel``."""
        group, rest = [], deque()
        for r in self._pending:
            if r.group_key == key and len(group) < cfg.max_batch:
                self._pending_counts[key] -= 1
                if r.future.set_running_or_notify_cancel():
                    group.append(r)
            else:
                rest.append(r)
        if self._pending_counts[key] <= 0:
            del self._pending_counts[key]
        self._pending = rest
        for r in group:
            # stride accounting: 1/weight virtual time per request, floored
            # at current vtime so an app idle for an hour does not bank an
            # hour of priority credit
            base = max(self._app_pass.get(r.app, self._vtime), self._vtime)
            self._app_pass[r.app] = base + 1.0 / cfg.weight_for(r.app)
        return group

    # ------------------------------------------------------------------
    def _run_group(self, group: list[_Request]) -> None:
        try:
            kind = group[0].group_key[0]
            if kind == "batch":
                self._run_batched(group)
            else:
                self._run_solo(group)
        except BaseException as exc:  # noqa: BLE001 — delivered via futures
            self.stats.record_failed(sum(1 for r in group
                                         if not r.future.done()))
            for r in group:
                if not r.future.done():
                    r.future.set_exception(exc)
        finally:
            self._inflight.release()

    def _run_batched(self, group: list[_Request]) -> None:
        spec = batch_spec(group[0].app)
        params = dict(group[0].params)
        max_iters = params.pop("max_iters")
        sources = [r.source for r in group]
        if self.config.pad_batches:
            # duplicate the tail source up to the next power of two (capped
            # at max_batch, which need not be one): the [n, K] engines then
            # number O(log max_batch) K values, matching warmup()'s ladder;
            # duplicated columns are computed-and-dropped
            k = min(_next_pow2(len(group)), self.config.max_batch)
            sources = sources + [sources[-1]] * (k - len(group))
        results = self.session.run_batch(
            spec.batched_app, max_iters=max_iters,
            **{spec.batch_param: sources}, **params)
        self.stats.record_batch(len(group))
        self._resolve(group, results[: len(group)])

    def _run_solo(self, group: list[_Request]) -> None:
        """Identical solo requests (one group_key == one exact query)
        coalesce into a single engine run resolving every future."""
        params = dict(group[0].params)
        result = self.session.run(group[0].app, **params)
        self.stats.record_batch(len(group))
        self._resolve(group, itertools.repeat(result))

    def _resolve(self, group: list[_Request], results) -> None:
        now = time.perf_counter()
        pairs = list(zip(group, results))
        # memoize BEFORE resolving: a client that has seen result() must be
        # able to resubmit the same query and hit the memo — resolving first
        # races its next submit against this insertion
        memo_items = [(r.memo_key, res) for r, res in pairs
                      if r.memo_key is not None]
        if memo_items and self.config.memo_capacity \
                and self.config.memo_budget_bytes:
            with self._cond:
                for key, res in memo_items:
                    nbytes = getattr(res.values, "nbytes", 0)
                    if nbytes > self.config.memo_budget_bytes:
                        continue  # one result outweighs the whole budget
                    old = self._memo.pop(key, None)
                    if old is not None:
                        self._memo_bytes -= old[1]
                    self._memo[key] = (res, nbytes)
                    self._memo_bytes += nbytes
                while len(self._memo) > self.config.memo_capacity \
                        or self._memo_bytes > self.config.memo_budget_bytes:
                    _, (_, dropped) = self._memo.popitem(last=False)
                    self._memo_bytes -= dropped
        for r, res in pairs:
            # stats before set_result: a client that has seen result() must
            # also see its completion counted in the very next snapshot
            self.stats.record_latency(now - r.t_submit, app=r.app)
            r.future.set_result(res)

    # ------------------------------------------------------------------
    def apply_mutations(self, inserts=None, deletes=None, updates=None, *,
                        refresh_memo: bool = True) -> MutationReport:
        """Commit edge mutations against the shared session, safely.

        Pauses dispatch, drains every in-flight sweep (by taking all
        ``max_inflight`` permits), commits through
        ``session.apply_mutations`` (the session must be ``mutable=True``),
        re-keys the memo under the new graph token, then resumes.  Pending
        requests admitted before the call simply execute after it, at the
        new epoch; in-flight sweeps finish at the old epoch before the
        commit lands, so no sweep ever mixes epochs.

        ``refresh_memo=True`` recomputes memoized results whose application
        is registered ``incremental=True`` via ``session.run_incremental``
        — for monotone deltas that costs the few frontier-local iterations
        the change propagates, per entry, instead of a cold sweep — and
        re-inserts them under the new token.  Everything else (PageRank
        entries, results predating the epoch log) is dropped and will be
        recomputed on next request.
        """
        with self._mutate_lock:
            with self._cond:
                if self._closing:
                    raise ServiceClosed("GraphService is closed")
                self._paused = True
            acquired = 0
            try:
                for _ in range(self.config.max_inflight):
                    self._inflight.acquire()
                    acquired += 1
                epoch = self.session.apply_mutations(
                    inserts=inserts, deletes=deletes, updates=updates)
                with self._cond:
                    stale = list(self._memo.items())
                    self._memo.clear()
                    self._memo_bytes = 0
                    self._graph_token = self._compute_graph_token(
                        self.session.store)
                    token = self._graph_token
                refreshed = []
                dropped = 0
                for (app, source, pkey, _old), (res, _nb) in stale:
                    new = (self._refresh_memo_entry(app, source, pkey, res)
                           if refresh_memo else None)
                    if new is None:
                        dropped += 1
                    else:
                        refreshed.append(((app, source, pkey, token), new))
                if refreshed:
                    with self._cond:
                        for key, res in refreshed:
                            nbytes = getattr(res.values, "nbytes", 0)
                            if nbytes > self.config.memo_budget_bytes:
                                continue
                            self._memo[key] = (res, nbytes)
                            self._memo_bytes += nbytes
                        while len(self._memo) > self.config.memo_capacity \
                                or self._memo_bytes \
                                > self.config.memo_budget_bytes:
                            _, (_, nb) = self._memo.popitem(last=False)
                            self._memo_bytes -= nb
                return MutationReport(epoch=epoch,
                                      memo_refreshed=len(refreshed),
                                      memo_dropped=dropped)
            finally:
                for _ in range(acquired):
                    self._inflight.release()
                with self._cond:
                    self._paused = False
                    self._cond.notify_all()

    def _refresh_memo_entry(self, app, source, pkey, prev):
        """Incrementally recompute one memo entry, or None to drop it.

        Only entries where ``run_incremental`` is guaranteed to take its
        seeded shortcut are refreshed — a fallback cold sweep per entry
        would turn one mutation into a full-memo recompute storm."""
        if not (is_incremental(app) and prev.converged):
            return None
        store = self.session.store
        monotone_since = getattr(store, "monotone_since", None)
        if monotone_since is None or not monotone_since(prev.epoch):
            return None
        if store.affected_sources_since(prev.epoch) is None:
            return None  # epoch log truncated past prev: would run cold
        params = dict(pkey)
        max_iters = params.pop("max_iters", self.config.max_iters)
        spec = batch_spec(app)
        if source is not None and spec is not None:
            params[spec.source_param] = source
        try:
            return self.session.run_incremental(app, prev=prev,
                                                max_iters=max_iters, **params)
        except Exception:
            return None  # a broken refresh drops the entry, never the commit

    # ------------------------------------------------------------------
    def warmup(self, apps=("sssp",)) -> None:
        """Build the engines (and, on the card, the kernels) the batching
        policy can hit: one ``max_iters=1`` run per (app, padded batch
        size).  Optional — first requests pay for them otherwise."""
        sizes = {1}
        if self.config.pad_batches:
            k = 1
            while k < self.config.max_batch:
                k = min(k * 2, self.config.max_batch)
                sizes.add(k)
        else:
            sizes = set(range(1, self.config.max_batch + 1))
        for app in apps:
            spec = batch_spec(app)
            if spec is None:
                self.session.run(app, max_iters=1)
                continue
            for k in sorted(sizes):
                self.session.run_batch(spec.batched_app, max_iters=1,
                                       **{spec.batch_param: list(range(k))})

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._pending)

    @property
    def is_closed(self) -> bool:
        """True once close() has begun — submit/reconfigure will raise."""
        with self._lock:
            return self._closing

    # ------------------------------------------------------------------
    RECONFIGURABLE = frozenset(
        {"max_batch", "max_wait_ms", "max_queue", "max_iters",
         "fair_weights"})

    def reconfigure(self, **changes) -> ServiceConfig:
        """Atomically retune the live batching policy; returns the new
        config.  This is ``AdaptiveServeController``'s write path, and it
        is safe mid-traffic: the dispatcher re-reads ``self.config`` on
        every pass, pending requests simply see the new limits on their
        next evaluation, and in-flight sweeps are untouched.

        Only ``RECONFIGURABLE`` fields may change (``max_inflight`` sizes
        a real thread pool, the memo knobs shape already-held state —
        restart for those); values are validated exactly like construction
        (``ServiceConfig.__post_init__``).  Raises ``ServiceClosed`` on a
        closed/closing service so a racing controller loop stops cleanly
        instead of resurrecting knobs on a corpse.
        """
        unknown = set(changes) - self.RECONFIGURABLE
        if unknown:
            raise ValueError(
                f"not reconfigurable at runtime: {sorted(unknown)} "
                f"(allowed: {sorted(self.RECONFIGURABLE)})")
        with self._cond:
            if self._closing:
                raise ServiceClosed("cannot reconfigure a closed "
                                    "GraphService")
            self.config = self.config.replace(**changes)
            # wake the dispatcher: a shorter max_wait_ms or smaller
            # max_batch can make a parked group ready right now
            self._cond.notify_all()
            return self.config

    def attach_hub(self, hub, prefix: str = "serve"):
        """Wire this service's stats into a ``MetricsHub``: the latency
        reservoirs are shared (adopted) and the counters exported as a
        poller, so every emitted snapshot carries serving state.  Returns
        ``hub`` for chaining."""
        self.stats.attach_hub(hub, prefix)
        return hub

    def close(self, drain: bool = True, timeout: float | None = None) -> None:
        """Stop accepting work and shut down.

        ``drain=True`` (default) runs every pending request to completion
        first; ``drain=False`` fails pending futures with ``ServiceClosed``
        (requests already executing still complete).  ``timeout`` bounds the
        drain (seconds); on expiry the remaining UNDISPATCHED requests are
        failed with ``ServiceClosed`` rather than left hanging — a client
        blocked in ``future.result()`` always gets an answer.  Idempotent.
        """
        with self._cond:
            if self._closed:
                return
            self._closing = True
            if not drain:
                self._fail_pending_locked()
            self._cond.notify_all()
        self._dispatcher.join(timeout)
        if self._dispatcher.is_alive():
            # drain timed out mid-backlog: fail what was never dispatched so
            # no caller waits forever, then let the dispatcher wind down
            with self._cond:
                self._fail_pending_locked()
                self._cond.notify_all()
            self._dispatcher.join()
        self._runners.shutdown(wait=True)
        self._closed = True

    def _fail_pending_locked(self) -> None:
        while self._pending:
            r = self._pending.popleft()
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(
                    ServiceClosed("GraphService closed before this "
                                  "request was dispatched"))
        self._pending_counts.clear()

    def __enter__(self) -> "GraphService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"GraphService({self.session!r}, max_batch="
                f"{self.config.max_batch}, queue={self.queue_depth})")
