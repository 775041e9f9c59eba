"""ShardPipeline: overlap shard fetch/decompress/staging with compute.

GraphMP's thesis is hiding disk behind compute (paper §2.3; NXgraph and
GraphH stream shards the same way).  The engine used to fetch every shard
synchronously inside the iteration loop, serializing disk reads, npz
parsing, cache decompression, and host->device staging with the Pallas
SpMV.  The pipeline moves all of that onto ONE background thread feeding a
bounded queue:

    worker:  fetch(p) -> stage(shard) -> queue.put        (depth items ahead)
    main  :  queue.get -> SpMV on the previous result

``prefetch_depth`` is the queue bound — 1 is classic double buffering, 0 is
the old synchronous path (same code path, no thread).  A SINGLE worker
fetching in schedule order is deliberate: cache accesses happen in exactly
the order the synchronous path would issue them, so hit/miss/eviction
sequences — and therefore the Table-3 disk-byte accounting — are bit-for-bit
identical at every depth.  (Multi-device engines keep that property per
device: ``ShardedVSWEngine`` runs one pipeline instance — a prefetch LANE —
per device over that device's slice of the schedule, each feeding its own
cache partition, with per-lane ``stats`` summing to the engine aggregates.)

``stats`` separates the two sides of the overlap: ``stall_seconds`` is time
the consumer spent blocked waiting on the queue (what prefetch is supposed
to drive to zero) and ``fetch_seconds`` is background time spent producing
shards (what it hides).

Memory interplay with the two-tier cache (core/cache.py): the worker's
``fetch`` is ``cache.get``, which may promote/demote/evict — every such
transition and its byte accounting happens inside the cache's lock, so
staging never races a promotion and the cache budget holds at every depth.
The pipeline itself holds up to ``depth`` staged shards in flight on top of
the cache; that host memory is charged to ``stats.staged_bytes`` (current)
and ``stats.staged_peak_bytes`` (high-water), bounded by
``depth × max shard bytes``.  It is deliberately NOT charged against the
cache budget: doing so would make eviction sequences — and therefore the
Table-3 disk-byte accounting — depend on prefetch depth, breaking the
bit-for-bit invariance contract above.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Iterator, Sequence

from repro_torch.core.shards import ELLShard

_DONE = object()


@dataclasses.dataclass
class PipelineStats:
    """Producer/consumer accounting.

    ``shards``/``stall_seconds``/``fetch_seconds`` are lifetime
    accumulators; ``staged_bytes`` is the host bytes of shards currently
    staged but not yet consumed (bounded by depth × max shard bytes) and
    ``staged_peak_bytes`` its lifetime high-water mark.
    """

    shards: int = 0           # shards delivered to the consumer
    stall_seconds: float = 0.0  # consumer time blocked on the queue
    fetch_seconds: float = 0.0  # producer time fetching + staging
    staged_bytes: int = 0       # staged-but-unconsumed host bytes (in flight)
    staged_peak_bytes: int = 0  # lifetime high-water mark of staged_bytes


@dataclasses.dataclass
class _Failure:
    exc: BaseException


class ShardPipeline:
    """Streams ``(shard_id, shard, staged)`` for a schedule, ``depth`` ahead.

    ``fetch``: shard_id -> ELLShard (typically ``cache.get``; must be safe to
    call from one background thread — the CompressedShardCache does every
    tier transition, including promotions, under its own lock).
    ``stage``: optional ELLShard -> anything; runs on the worker too, so
    host->device transfers land off the critical path.  With ``depth == 0``
    both run inline on the consumer thread (the synchronous path).
    ``nbytes``: optional ELLShard -> int used to charge staged-but-unconsumed
    shards to ``stats.staged_bytes`` (the pipeline's own memory footprint on
    top of the cache budget).
    """

    def __init__(self, fetch: Callable[[int], ELLShard], depth: int = 0,
                 stage: Callable[[ELLShard], Any] | None = None,
                 nbytes: Callable[[ELLShard], int] | None = None):
        if depth < 0:
            raise ValueError(f"prefetch depth must be >= 0, got {depth}")
        self.fetch = fetch
        self.stage = stage
        self.nbytes = nbytes
        self.depth = int(depth)
        self.stats = PipelineStats()
        self._stats_lock = threading.Lock()  # producer + consumer both charge

    def _charge(self, n: int) -> None:
        with self._stats_lock:
            self.stats.staged_bytes += n
            self.stats.staged_peak_bytes = max(self.stats.staged_peak_bytes,
                                               self.stats.staged_bytes)

    def _produce(self, p: int,
                 check: Callable[[int], None] | None) -> tuple[int, ELLShard, Any, int]:
        t0 = time.perf_counter()
        if check is not None:
            check(p)  # epoch pin: refuse to stage a shard from a newer epoch
        shard = self.fetch(p)
        staged = self.stage(shard) if self.stage is not None else None
        held = self.nbytes(shard) if self.nbytes is not None else 0
        self._charge(held)
        self.stats.fetch_seconds += time.perf_counter() - t0
        return p, shard, staged, held

    def stream(self, schedule: Sequence[int],
               check: Callable[[int], None] | None = None,
               ) -> Iterator[tuple[int, ELLShard, Any]]:
        """Yield every shard of ``schedule`` in order, prefetching ahead.

        ``check`` (optional) runs on the producer immediately before each
        fetch; the engine passes its epoch-pin assertion so a mid-run graph
        mutation raises ``ConcurrentMutationError`` instead of silently
        staging a shard from a newer epoch into an older run.
        """
        # a single-shard schedule has nothing to overlap with — skip the
        # worker thread (same order, same accounting, no spawn cost)
        if self.depth == 0 or len(schedule) < 2:
            for p in schedule:
                t0 = time.perf_counter()
                pid, shard, staged, held = self._produce(p, check)
                # synchronous path: the consumer IS stalled for the whole fetch
                self.stats.stall_seconds += time.perf_counter() - t0
                self.stats.shards += 1
                self._charge(-held)  # delivered: no longer in flight
                yield pid, shard, staged
            return

        q: queue.Queue = queue.Queue(maxsize=self.depth)
        cancel = threading.Event()

        def worker() -> None:
            try:
                for p in schedule:
                    if cancel.is_set():
                        return
                    q.put(self._produce(p, check))
                q.put(_DONE)
            except BaseException as exc:  # noqa: BLE001 — forwarded, re-raised
                q.put(_Failure(exc))

        t = threading.Thread(target=worker, name="shard-prefetch", daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                self.stats.stall_seconds += time.perf_counter() - t0
                if item is _DONE:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                pid, shard, staged, held = item
                self.stats.shards += 1
                self._charge(-held)  # delivered: no longer in flight
                yield pid, shard, staged
        finally:
            cancel.set()
            # unblock a worker parked on q.put, then reap it; de-charge
            # drained items so staged_bytes never counts abandoned shards
            while t.is_alive():
                try:
                    item = q.get_nowait()
                    if isinstance(item, tuple):
                        self._charge(-item[3])
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
            # the worker may have completed one last q.put between the drain
            # and its cancel check — sweep whatever is still queued
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    break
                if isinstance(item, tuple):
                    self._charge(-item[3])
