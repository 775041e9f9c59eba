"""Compressed edge cache (paper §2.4.2): static modes 0-4 + two-tier adaptive.

Spare host memory caches shard data; decompression throughput beats disk.
snappy/zlib-1/zlib-3 from the paper map onto zstd levels 1/3/9, falling back
to the paper's own zlib (levels 1/3/9) when zstandard is not installed — see
docs/ARCHITECTURE.md, "Edge cache: two tiers under one budget"; the mode
semantics, γ table and auto-selection rule `min i s.t. S/γᵢ ≤ C` are kept
verbatim from the paper.

  mode 0: no application cache (OS page cache only)    γ₀ = 1
  mode 1: cache raw (uncompressed) shard arrays        γ₁ = 1 (paper: 2*)
  mode 2: cache zstd-1 blobs   (paper: snappy)         γ₂ = 2
  mode 3: cache zstd-3 blobs   (paper: zlib-1)         γ₃ = 4
  mode 4: cache zstd-9 blobs   (paper: zlib-3)         γ₄ = 5

(*the paper's γ₁=2 reflects that its disk format is CSV-ish while its cache
is binary; our disk format is already binary ELL, so γ₁=1. The selection
rule is unchanged.)

**Static** caches (``mode`` = an int) pick one of the five modes for the
whole cache lifetime — the paper's design, kept as the baseline.  The
default ``mode="auto"`` (alias ``"adaptive"``) is the **two-tier adaptive**
cache: the paper's rule becomes the *admission default*, not a lifetime
commitment.

  * **cold tier** — zstd blobs at the admission level (the rule's pick,
    floored at mode 2 so a first-touch shard always enters compressed);
  * **hot tier** — decompressed ``ELLShard`` arrays: a hit costs zero
    decode.  A shard is promoted cold→hot once it has been touched
    ``promote_after`` times (hubs and frontier-dense shards are touched
    every iteration; rarely-scheduled shards stay compressed or fall out);
    when the hot tier is full it may only displace a STRICTLY
    less-frequently-used resident, so equal-heat shards (a uniform
    PageRank sweep) never promote/demote ping-pong.
  * **budget** — one strict byte budget covers BOTH tiers
    (``hot_bytes + cold_bytes <= budget`` after every operation); the hot
    tier is additionally capped at ``hot_fraction * budget``.  Eviction
    cascades hot→cold→out: the hot LRU shard is *demoted* (re-compressed
    into the cold tier), the cold LRU blob falls out of the cache.
  * ``budget_bytes=0`` degrades to mode 0 (no application cache at all).

Every placement decision is a deterministic function of the ``get``
sequence, so results, hit/miss sequences and the Table-3 disk-byte
accounting are invariant to storage backend and prefetch depth (property
tests in tests/test_backends.py).

The cache sits on any ``ShardSource`` backend (npz directory, packed file,
in-memory — graph/source.py) and is **thread-safe**: the ShardPipeline calls
``get`` from a prefetch thread while stats are read from the main loop, so
every get/promotion/demotion/eviction and every ``CacheStats`` update
happens under one lock.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
import zlib
from collections import OrderedDict

import numpy as np

try:
    import zstandard
except ImportError:  # optional: compressed tiers fall back to stdlib zlib
    zstandard = None

from repro_torch.core.shards import ELLShard
from repro_torch.graph.source import ShardSource, pack_shard_npz, unpack_shard_npz

GAMMA = {0: 1.0, 1: 1.0, 2: 2.0, 3: 4.0, 4: 5.0}
ZSTD_LEVEL = {2: 1, 3: 3, 4: 9}
ZLIB_LEVEL = {2: 1, 3: 3, 4: 9}  # the paper's own codec, always available


def _make_codec(mode: int):
    """(compress, decompress) for a compressed mode: zstd, else zlib."""
    if zstandard is not None:
        cctx = zstandard.ZstdCompressor(level=ZSTD_LEVEL[mode])
        dctx = zstandard.ZstdDecompressor()
        return cctx.compress, dctx.decompress
    level = ZLIB_LEVEL[mode]
    return (lambda blob: zlib.compress(blob, level)), zlib.decompress

# canonical blob codecs, shared with the storage backends
_unpack = unpack_shard_npz
_pack = pack_shard_npz

ADAPTIVE_MODES = ("auto", "adaptive")


def auto_select_mode(graph_bytes: int, cache_budget_bytes: int) -> int:
    """Paper's rule: minimal i with S/γᵢ ≤ C; fall back to mode 4."""
    for i in range(5):
        if graph_bytes / GAMMA[i] <= cache_budget_bytes:
            return i
    return 4


@dataclasses.dataclass
class CacheStats:
    """Lifetime counters; mutate through ``bump`` (atomic under a lock).

    ``hits``/``misses``/``evictions`` keep their historic meaning (an
    eviction drops a shard out of the cache entirely).  The two-tier cache
    splits hits into ``hot_hits`` (decompressed array returned as-is, zero
    decode) and ``cold_hits`` (blob decompressed on the way out), and counts
    tier migrations: ``promotions`` (cold→hot) and ``demotions`` (hot→cold).
    ``decode_seconds_saved`` accumulates, on every hot hit, the measured
    decompress+unpack cost that hit did NOT pay — the hot tier's benefit in
    seconds (compare against ``decompress_seconds``, what the cold tier and
    a static compressed cache DO pay).
    """

    hits: int = 0
    misses: int = 0
    disk_bytes: int = 0
    decompress_seconds: float = 0.0
    compress_seconds: float = 0.0
    evictions: int = 0
    hot_hits: int = 0
    cold_hits: int = 0
    promotions: int = 0
    demotions: int = 0
    decode_seconds_saved: float = 0.0
    stale_drops: int = 0  # entries dropped because their shard's epoch moved

    def __post_init__(self):
        self._lock = threading.Lock()

    def bump(self, **deltas) -> None:
        with self._lock:
            for field, delta in deltas.items():
                setattr(self, field, getattr(self, field) + delta)

    @property
    def hit_ratio(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class CompressedShardCache:
    """Budget-enforced shard cache over a ShardSource: static or two-tier.

    Parameters
    ----------
    store:
        Any ``ShardSource`` backend; misses are charged to its byte counter
        at the shard's canonical nbytes (Table-3 accounting).
    mode:
        ``"auto"``/``"adaptive"`` (default) — the two-tier adaptive cache;
        an int 0-4 — the paper's static modes, kept as baselines.
    budget_bytes:
        Strict byte budget across both tiers; 0 degrades to mode 0.
    hot_fraction:
        Fraction of the budget the hot (decompressed) tier may occupy
        (adaptive only).
    promote_after:
        Accesses (including the admitting miss) after which a cold shard
        becomes a promotion candidate (adaptive only).
    """

    def __init__(self, store: ShardSource, mode: int | str = "auto",
                 budget_bytes: int = 1 << 30, *,
                 hot_fraction: float = 0.5, promote_after: int = 2):
        self.store = store
        self.budget = int(budget_bytes)
        if self.budget < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes!r}")
        if not 0.0 < hot_fraction <= 1.0:
            raise ValueError(
                f"hot_fraction must be in (0, 1], got {hot_fraction!r}")
        if promote_after < 1:
            raise ValueError(
                f"promote_after must be >= 1, got {promote_after!r}")
        self.hot_fraction = float(hot_fraction)
        self.promote_after = int(promote_after)
        self.adaptive = mode in ADAPTIVE_MODES
        if self.budget == 0:
            # a zero budget cannot hold anything: degrade to mode 0 (no
            # application cache) whatever policy was asked for
            self.adaptive = False
            mode = 0
        if self.adaptive:
            # the paper's rule picks the admission level; the floor at mode 2
            # means a first-touch shard always enters compressed (the hot
            # tier is earned by reuse, not granted on admission)
            rule = auto_select_mode(store.total_shard_bytes(), self.budget)
            mode = max(2, rule)
        if int(mode) in ZSTD_LEVEL and zstandard is None:
            warnings.warn(
                "zstandard is not installed; compressed cache modes use "
                "stdlib zlib (the paper's codec; slower than zstd)",
                RuntimeWarning, stacklevel=2)
        self.mode = int(mode)
        self.stats = CacheStats()
        # static tier (modes 1-4): one LRU of bytes-or-ELLShard entries
        self._lru: OrderedDict[int, bytes | ELLShard] = OrderedDict()
        self._bytes = 0
        # adaptive tiers: hot = decompressed shards, cold = zstd blobs,
        # plus per-shard lifetime access counts and measured decode costs
        self._hot: OrderedDict[int, ELLShard] = OrderedDict()
        self._cold: OrderedDict[int, bytes] = OrderedDict()
        self._hot_bytes = 0
        self._cold_bytes = 0
        self._freq: dict[int, int] = {}
        self._decode_cost: dict[int, float] = {}
        # epoch each resident entry was cached at: a mutable store bumps a
        # shard's epoch on commit, and `get` lazily drops ONLY that shard's
        # entry (clean shards keep their hot/cold placement across mutations)
        self._epoch_of: dict[int, int] = {}
        self._lock = threading.RLock()  # prefetch thread(s) + main loop
        self._compress, self._decompress = (
            _make_codec(self.mode) if self.mode in ZSTD_LEVEL
            else (None, None))

    # -- occupancy ------------------------------------------------------
    @property
    def hot_budget(self) -> int:
        """Byte cap of the hot tier (adaptive; static mode 1 IS a hot tier)."""
        if self.adaptive:
            return int(self.budget * self.hot_fraction)
        return self.budget if self.mode == 1 else 0

    @property
    def hot_bytes(self) -> int:
        if self.adaptive:
            return self._hot_bytes
        return self._bytes if self.mode == 1 else 0

    @property
    def cold_bytes(self) -> int:
        if self.adaptive:
            return self._cold_bytes
        return self._bytes if self.mode in ZSTD_LEVEL else 0

    @property
    def hot_shards(self) -> int:
        if self.adaptive:
            return len(self._hot)
        return len(self._lru) if self.mode == 1 else 0

    @property
    def cold_shards(self) -> int:
        if self.adaptive:
            return len(self._cold)
        return len(self._lru) if self.mode in ZSTD_LEVEL else 0

    @property
    def cached_bytes(self) -> int:
        return self._hot_bytes + self._cold_bytes if self.adaptive else self._bytes

    @property
    def cached_shards(self) -> int:
        return len(self._hot) + len(self._cold) if self.adaptive else len(self._lru)

    def shard_tier(self, shard_id: int) -> str:
        """'hot' | 'cold' | 'out' — where a shard currently lives."""
        with self._lock:
            if self.adaptive:
                if shard_id in self._hot:
                    return "hot"
                return "cold" if shard_id in self._cold else "out"
            if shard_id not in self._lru:
                return "out"
            return "hot" if isinstance(self._lru[shard_id], ELLShard) else "cold"

    def _entry_nbytes(self, entry) -> int:
        if isinstance(entry, bytes):
            return len(entry)
        return entry.decoded_nbytes()

    # -- adaptive internals (all callers hold self._lock) ---------------
    def _demote(self, shard_id: int, shard: ELLShard) -> None:
        """Hot LRU leaves the hot tier: re-compressed into the cold tier."""
        t = time.perf_counter()
        blob = self._compress(_pack(shard))
        self.stats.bump(compress_seconds=time.perf_counter() - t,
                        demotions=1)
        self._cold[shard_id] = blob  # most-recently-used end of the cold LRU
        self._cold_bytes += len(blob)

    def _enforce(self) -> None:
        """Restore both invariants by the hot→cold→out cascade."""
        hot_budget = self.hot_budget
        while self._hot_bytes > hot_budget and self._hot:
            sid, shard = self._hot.popitem(last=False)
            self._hot_bytes -= self._entry_nbytes(shard)
            self._demote(sid, shard)
        while self._hot_bytes + self._cold_bytes > self.budget and self._cold:
            sid, blob = self._cold.popitem(last=False)
            self._cold_bytes -= len(blob)
            self.stats.bump(evictions=1)

    def _should_promote(self, shard_id: int, shard: ELLShard) -> bool:
        if self._freq.get(shard_id, 0) < self.promote_after:
            return False
        need = self._entry_nbytes(shard)
        hot_budget = self.hot_budget
        if need > hot_budget:
            return False
        if self._hot_bytes + need <= hot_budget:
            return True
        # tier is full: displace only if strictly hotter than the coolest
        # resident (equal heat = no churn; PageRank's uniform sweeps settle)
        lru_id = next(iter(self._hot))
        return self._freq[shard_id] > self._freq.get(lru_id, 0)

    def _get_adaptive(self, shard_id: int) -> ELLShard:
        if shard_id in self._hot:
            shard = self._hot.pop(shard_id)
            self._hot[shard_id] = shard  # LRU bump
            self._freq[shard_id] = self._freq.get(shard_id, 0) + 1
            self.stats.bump(hits=1, hot_hits=1,
                            decode_seconds_saved=self._decode_cost.get(
                                shard_id, 0.0))
            return shard
        if shard_id in self._cold:
            blob = self._cold.pop(shard_id)
            self._freq[shard_id] = self._freq.get(shard_id, 0) + 1
            t = time.perf_counter()
            shard = _unpack(shard_id, self._decompress(blob))
            dt = time.perf_counter() - t
            self._decode_cost[shard_id] = dt
            self.stats.bump(hits=1, cold_hits=1, decompress_seconds=dt)
            if self._should_promote(shard_id, shard):
                self._cold_bytes -= len(blob)
                self._hot[shard_id] = shard
                self._hot_bytes += self._entry_nbytes(shard)
                self.stats.bump(promotions=1)
                self._enforce()
            else:
                self._cold[shard_id] = blob  # LRU bump, stays compressed
            return shard
        # miss: one canonical blob read serves decode AND admission
        self.stats.bump(misses=1,
                        disk_bytes=self.store.shard_nbytes(shard_id))
        self._freq[shard_id] = self._freq.get(shard_id, 0) + 1
        blob = self.store.read_shard_bytes(shard_id)
        shard = _unpack(shard_id, blob)
        t = time.perf_counter()
        centry = self._compress(blob)
        self.stats.bump(compress_seconds=time.perf_counter() - t)
        if len(centry) <= self.budget:
            self._cold[shard_id] = centry
            self._cold_bytes += len(centry)
            self._enforce()
        return shard

    # -- epoch-grained invalidation (mutable stores) ---------------------
    def _store_shard_epoch(self, shard_id: int) -> int:
        fn = getattr(self.store, "shard_epoch", None)
        return int(fn(shard_id)) if fn is not None else 0

    def _invalidate_locked(self, shard_id: int) -> bool:
        dropped = False
        entry = self._hot.pop(shard_id, None)
        if entry is not None:
            self._hot_bytes -= self._entry_nbytes(entry)
            dropped = True
        blob = self._cold.pop(shard_id, None)
        if blob is not None:
            self._cold_bytes -= len(blob)
            dropped = True
        entry = self._lru.pop(shard_id, None)
        if entry is not None:
            self._bytes -= self._entry_nbytes(entry)
            dropped = True
        if dropped:
            # not an `eviction` (those mean budget pressure): a stale drop
            self.stats.bump(stale_drops=1)
        return dropped

    def invalidate(self, shard_ids=None) -> int:
        """Eagerly drop the entries of ``shard_ids`` (default: every shard
        whose epoch moved since it was cached); returns the drop count.
        ``get`` does this lazily per shard, so calling this is optional."""
        with self._lock:
            if shard_ids is None:
                resident = set(self._hot) | set(self._cold) | set(self._lru)
                shard_ids = [p for p in resident
                             if self._store_shard_epoch(p)
                             != self._epoch_of.get(p, 0)]
            dropped = 0
            for p in shard_ids:
                if self._invalidate_locked(p):
                    dropped += 1
                self._epoch_of.pop(p, None)
            return dropped

    # -- the one public entry point -------------------------------------
    def get(self, shard_id: int) -> ELLShard:
        """Return a decoded shard, through whatever tier currently holds it.

        Thread-safe; every byte-accounting invariant
        (``cached_bytes <= budget``, and for the adaptive cache
        ``hot_bytes <= hot_fraction * budget``) holds on return.
        """
        with self._lock:
            cur = self._store_shard_epoch(shard_id)
            if cur != self._epoch_of.get(shard_id, 0):
                self._invalidate_locked(shard_id)
                self._epoch_of[shard_id] = cur
            if self.adaptive:
                return self._get_adaptive(shard_id)
            if self.mode == 0:
                self.stats.bump(misses=1,
                                disk_bytes=self.store.shard_nbytes(shard_id))
                return self.store.read_shard(shard_id)
            if shard_id in self._lru:
                entry = self._lru.pop(shard_id)
                self._lru[shard_id] = entry  # LRU bump
                if isinstance(entry, bytes):
                    t = time.perf_counter()
                    blob = self._decompress(entry)
                    self.stats.bump(hits=1, cold_hits=1,
                                    decompress_seconds=time.perf_counter() - t)
                    return _unpack(shard_id, blob)
                self.stats.bump(hits=1, hot_hits=1)
                return entry
            # miss: disk read, then insert if it fits
            self.stats.bump(misses=1,
                            disk_bytes=self.store.shard_nbytes(shard_id))
            if self.mode == 1:
                shard = self.store.read_shard(shard_id)
                entry: bytes | ELLShard = shard
            else:
                # compress the canonical blob straight off the backend — no
                # decode->re-encode round trip on the miss path
                blob = self.store.read_shard_bytes(shard_id)
                shard = _unpack(shard_id, blob)
                t = time.perf_counter()
                entry = self._compress(blob)
                self.stats.bump(compress_seconds=time.perf_counter() - t)
            need = self._entry_nbytes(entry)
            if need <= self.budget:
                self._evict_until(need)
                self._lru[shard_id] = entry
                self._bytes += need
            return shard

    def _evict_until(self, need: int) -> None:
        while self._bytes + need > self.budget and self._lru:
            _, old = self._lru.popitem(last=False)
            self._bytes -= self._entry_nbytes(old)
            self.stats.bump(evictions=1)

    # -- maintenance / observability -------------------------------------
    def clear(self) -> None:
        """Drop every cached entry and placement state (budget and stats
        are kept)."""
        with self._lock:
            self._lru.clear()
            self._bytes = 0
            self._hot.clear()
            self._cold.clear()
            self._hot_bytes = 0
            self._cold_bytes = 0
            self._freq.clear()
            self._epoch_of.clear()

    def audit(self) -> int:
        """Recount both tiers from scratch and assert the running byte
        counters match exactly; returns ``cached_bytes``.  Used by the
        concurrency tests after every operation — any drift between the
        counters and the actual entries is an accounting bug."""
        with self._lock:
            hot = sum(self._entry_nbytes(s) for s in self._hot.values())
            cold = sum(len(b) for b in self._cold.values())
            static = sum(self._entry_nbytes(e) for e in self._lru.values())
            assert hot == self._hot_bytes, (hot, self._hot_bytes)
            assert cold == self._cold_bytes, (cold, self._cold_bytes)
            assert static == self._bytes, (static, self._bytes)
            total = self.cached_bytes
            assert total <= self.budget, (total, self.budget)
            assert self.hot_bytes <= max(self.hot_budget, 0)
            return total

    def measured_ratio(self) -> float:
        """Achieved compression ratio over currently compressed entries."""
        with self._lock:
            if self.adaptive:
                if not self._cold:
                    return 1.0
                raw = sum(self.store.shard_nbytes(i) for i in self._cold)
                return raw / max(self._cold_bytes, 1)
            if self.mode in (0, 1) or not self._lru:
                return 1.0
            raw = sum(self.store.shard_nbytes(i) for i in self._lru)
            return raw / max(self._bytes, 1)

    def report(self) -> dict:
        """One self-describing snapshot of policy, occupancy and counters
        (what ``GraphSession.cache_report()`` returns)."""
        with self._lock:
            s = self.stats
            return {
                "policy": "adaptive" if self.adaptive else "static",
                "mode": self.mode,
                "budget_bytes": self.budget,
                "hot_budget_bytes": self.hot_budget,
                "hot_bytes": self.hot_bytes,
                "hot_shards": self.hot_shards,
                "cold_bytes": self.cold_bytes,
                "cold_shards": self.cold_shards,
                "cached_bytes": self.cached_bytes,
                "cached_shards": self.cached_shards,
                "hits": s.hits,
                "hot_hits": s.hot_hits,
                "cold_hits": s.cold_hits,
                "misses": s.misses,
                "hit_ratio": s.hit_ratio,
                "promotions": s.promotions,
                "demotions": s.demotions,
                "evictions": s.evictions,
                "stale_drops": s.stale_drops,
                "disk_bytes": s.disk_bytes,
                "decompress_seconds": s.decompress_seconds,
                "compress_seconds": s.compress_seconds,
                "decode_seconds_saved": s.decode_seconds_saved,
                "measured_ratio": self.measured_ratio(),
            }


# ---------------------------------------------------------------------------
class PartitionedShardCache:
    """Per-device slices of the edge cache under ONE global byte budget.

    The multi-device engine (``repro_torch.core.distributed.ShardedVSWEngine``)
    splits the shard schedule across device lanes; each lane's shards hash
    to its own ``CompressedShardCache`` partition (``owner[p]`` names the
    partition caching shard ``p``), so per-device prefetch lanes never
    contend on one LRU and the Table-3 disk-byte accounting splits honestly
    per device.  The partition budgets sum EXACTLY to the configured global
    budget (partition 0 absorbs the remainder), keeping the strict-budget
    invariant of the single cache.

    The facade keeps the single-cache surface (``get`` / ``stats`` /
    ``report`` / ``clear`` / ``audit`` / ``invalidate`` / ``cached_bytes``)
    so ``GraphSession`` observability and the serving layer work unchanged;
    ``stats`` aggregates the partition counters into one ``CacheStats``.
    """

    def __init__(self, store: ShardSource, owner, num_partitions: int,
                 mode: int | str = "auto", budget_bytes: int = 1 << 30,
                 hot_fraction: float = 0.5, promote_after: int = 2):
        self.store = store
        self.owner = np.asarray(owner, dtype=np.int64)
        self.num_partitions = int(num_partitions)
        if self.num_partitions < 1:
            raise ValueError(
                f"num_partitions must be >= 1, got {num_partitions!r}")
        if self.owner.size and int(self.owner.max()) >= self.num_partitions:
            raise ValueError(
                f"owner maps shards to partition {int(self.owner.max())}, "
                f"but only {self.num_partitions} partitions exist")
        per = budget_bytes // self.num_partitions
        budgets = ([budget_bytes - per * (self.num_partitions - 1)]
                   + [per] * (self.num_partitions - 1))
        self.parts = [
            CompressedShardCache(store, mode=mode, budget_bytes=b,
                                 hot_fraction=hot_fraction,
                                 promote_after=promote_after)
            for b in budgets
        ]

    def partition_for(self, shard_id: int) -> CompressedShardCache:
        return self.parts[int(self.owner[shard_id])]

    def get(self, shard_id: int) -> ELLShard:
        return self.partition_for(shard_id).get(shard_id)

    def invalidate(self, shard_ids=None) -> int:
        return sum(p.invalidate(shard_ids) for p in self.parts)

    # -- aggregated observability (single-cache surface) ----------------
    @property
    def mode(self):
        return self.parts[0].mode

    @property
    def adaptive(self) -> bool:
        return self.parts[0].adaptive

    @property
    def budget(self) -> int:
        return sum(p.budget for p in self.parts)

    @property
    def cached_bytes(self) -> int:
        return sum(p.cached_bytes for p in self.parts)

    @property
    def cached_shards(self) -> int:
        return sum(p.cached_shards for p in self.parts)

    @property
    def stats(self) -> CacheStats:
        """Fresh aggregate of every partition's counters (the partitions
        keep their own live ``CacheStats``; mutate those, not this)."""
        agg = CacheStats()
        for part in self.parts:
            s = part.stats
            for f in dataclasses.fields(CacheStats):
                setattr(agg, f.name, getattr(agg, f.name) + getattr(s, f.name))
        return agg

    def clear(self) -> None:
        for p in self.parts:
            p.clear()

    def audit(self) -> int:
        return sum(p.audit() for p in self.parts)

    def report(self) -> dict:
        """Aggregate + per-partition snapshot (``partitions`` holds one
        ordinary cache report per device slice)."""
        s = self.stats
        return {
            "policy": "partitioned",
            "num_partitions": self.num_partitions,
            "mode": self.mode,
            "budget_bytes": self.budget,
            "cached_bytes": self.cached_bytes,
            "cached_shards": self.cached_shards,
            "hits": s.hits,
            "misses": s.misses,
            "hit_ratio": s.hit_ratio,
            "evictions": s.evictions,
            "stale_drops": s.stale_drops,
            "disk_bytes": s.disk_bytes,
            "decompress_seconds": s.decompress_seconds,
            "decode_seconds_saved": s.decode_seconds_saved,
            "partitions": [p.report() for p in self.parts],
        }
