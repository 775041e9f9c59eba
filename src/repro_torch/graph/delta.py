"""DeltaGraphStore: a mutable overlay over any frozen ShardSource backend.

GraphMP's VSW engine streams immutable destination-interval shards; this
module makes the graph mutable without the engine knowing.  A
``DeltaGraphStore`` wraps a base backend (npz directory, packed ``.gmpk``,
or RAM-resident) and keeps mutated shards as merged in-memory ``ELLShard``
views behind the exact same ``read_shard`` protocol:

  * ``apply(inserts=…, deletes=…)`` commits one **batch** of edge edits.
    Each commit bumps the store's **graph epoch** (a monotonic counter that
    replaces ``mtime_ns`` as the graph-identity/invalidation key) and stamps
    the touched shards with that epoch, so the cache and serve memo layers
    can invalidate *only* what changed.
  * Merging is **eager**: the dirty shard is re-laid out (CSR → blocked-ELL
    with the base store's layout parameters) at commit time, so
    ``properties`` (shard meta, ``num_edges``), degree arrays, Bloom
    filters, and canonical disk-byte accounting are consistent the moment
    ``apply`` returns — a run on the overlay is bitwise-identical to a run
    on the equivalent pre-merged frozen graph.
  * ``repro_torch.graph.compact.compact`` folds the merged shards back into the
    base (rewriting only dirty shards) and releases the overlay memory.

Edit semantics are simple-digraph per ``(src, dst)`` key: an insert of an
edge that already exists is a weight **upsert** (parallel base copies
collapse to the single new edge); a delete removes every parallel copy; the
vertex set is fixed at wrap time.  A bounded per-epoch log records which
*source* vertices were touched and whether the commit was monotone for
min-propagation apps (insert-only / weight-non-increasing), which is what
``session.run_incremental`` seeds its frontier from.

Env knobs: ``GRAPHMP_DELTA_BUDGET`` caps resident overlay bytes (0 =
unbounded); when exceeded, ``GRAPHMP_DELTA_AUTOCOMPACT=1`` (default)
triggers an automatic ``compact()``, otherwise ``apply`` raises
``DeltaBudgetError``.
"""
from __future__ import annotations

import math
import os
import threading

import numpy as np

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.shards import (CSRShard, ELLShard, csr_to_ell,
                                     quantize_shard)
from repro_torch.graph.source import ShardSourceBase, pack_shard_npz

_EPOCH_LOG_CAP = 256  # commits remembered for incremental-recompute seeding


class DeltaBudgetError(RuntimeError):
    """Overlay memory exceeded GRAPHMP_DELTA_BUDGET with auto-compact off."""


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _as_edge_arrays(edges, weighted_default: float = 1.0):
    """Normalize an edge batch to (src[int64], dst[int64], val[float32]).

    Accepts ``(src, dst)`` / ``(src, dst, val)`` array tuples or an iterable
    of ``(s, d)`` / ``(s, d, v)`` triples.  ``None``/empty → three empty
    arrays.
    """
    if edges is None:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=np.float32)
    if isinstance(edges, tuple) and len(edges) in (2, 3) and \
            not np.isscalar(edges[0]):
        src = np.asarray(edges[0], dtype=np.int64).ravel()
        dst = np.asarray(edges[1], dtype=np.int64).ravel()
        val = (np.asarray(edges[2], dtype=np.float32).ravel()
               if len(edges) == 3
               else np.full(src.size, weighted_default, dtype=np.float32))
    else:
        rows = list(edges)
        src = np.array([r[0] for r in rows], dtype=np.int64)
        dst = np.array([r[1] for r in rows], dtype=np.int64)
        val = np.array([r[2] if len(r) > 2 else weighted_default
                        for r in rows], dtype=np.float32)
    if not (src.size == dst.size == val.size):
        raise ValueError("edge arrays must have matching lengths")
    return src, dst, val


def _ell_to_csr_triples(shard: ELLShard):
    """Decode a blocked-ELL shard back to CSR-ordered (local_dst, src, val).

    ``np.nonzero`` walks the [R, W] mask in C order — increasing ELL row,
    then column — which is exactly the original CSR edge order (wrapped rows
    of one destination are consecutive, padding rows are all-sentinel).
    """
    mask = shard.cols >= 0
    r_idx, c_idx = np.nonzero(mask)
    local = shard.row_map[r_idx].astype(np.int64)
    # vals_f32 dequantizes int8/float16 edge values (float32 passes through)
    return local, shard.cols[r_idx, c_idx].astype(np.int64), \
        shard.vals_f32()[r_idx, c_idx].astype(np.float32)


class DeltaGraphStore(ShardSourceBase):
    """Mutable overlay: frozen base + in-memory merged views of dirty shards.

    Thread-safe: reads and ``apply`` serialize on an internal RLock (the
    engine additionally pins the epoch per run and refuses shards from a
    newer one — see ``ShardPipeline``).  Byte accounting is delegated to the
    base store's counter so session/service stats keep one ledger.
    """

    def __init__(self, base, *, delta_budget_bytes: int | None = None,
                 auto_compact: bool | None = None):
        self.base = base
        self.io = base.io
        self._lock = threading.RLock()
        self._epoch = 0
        self._shard_epoch: dict[int, int] = {}
        # overlay state per dirty shard (cleared by compaction)
        self._merged: dict[int, ELLShard] = {}
        self._blobs: dict[int, bytes] = {}
        self._blooms: dict[int, BloomFilter] = {}
        # graph-level state, forked lazily from the base on first commit
        prop = base.properties
        self._prop = dict(prop)
        self._prop["shards"] = [dict(m) for m in prop["shards"]]
        self._in_deg, self._out_deg = (np.array(a, dtype=np.int64, copy=True)
                                       for a in base.read_vertex_info())
        self._intervals = np.asarray(prop["intervals"], dtype=np.int64)
        # epoch log: (epoch, affected_source_vertices, monotone) per commit
        self._log: list[tuple[int, np.ndarray, bool]] = []
        self._log_floor = 0  # epochs <= floor have been forgotten
        if delta_budget_bytes is None:
            delta_budget_bytes = _env_int("GRAPHMP_DELTA_BUDGET", 0)
        if auto_compact is None:
            auto_compact = _env_int("GRAPHMP_DELTA_AUTOCOMPACT", 1) != 0
        self.delta_budget_bytes = int(delta_budget_bytes)
        self.auto_compact = bool(auto_compact)
        self._lane = self._infer_lane()

    # -- identity / passthrough --------------------------------------------
    @property
    def path(self):
        return getattr(self.base, "path", "<delta>")

    @property
    def properties(self) -> dict:
        return self._prop

    def close(self) -> None:
        close = getattr(self.base, "close", None)
        if close is not None:
            close()

    def __repr__(self) -> str:
        return (f"DeltaGraphStore(base={type(self.base).__name__}, "
                f"epoch={self._epoch}, dirty={len(self._merged)})")

    # -- ShardSource surface ------------------------------------------------
    def read_vertex_info(self):
        with self._lock:
            if not self._shard_epoch:  # pristine: identical to base
                return self.base.read_vertex_info()
            self.io.add_read(self._in_deg.nbytes + self._out_deg.nbytes)
            return self._in_deg.copy(), self._out_deg.copy()

    def read_shard(self, shard_id: int) -> ELLShard:
        with self._lock:
            merged = self._merged.get(shard_id)
            if merged is None:
                return self.base.read_shard(shard_id)
            self.io.add_read(len(self._blobs[shard_id]))  # canonical charge
            return merged

    def read_shard_bytes(self, shard_id: int) -> bytes:
        with self._lock:
            blob = self._blobs.get(shard_id)
            if blob is None:
                return self.base.read_shard_bytes(shard_id)
            self.io.add_read(len(blob))
            return blob

    def shard_nbytes(self, shard_id: int) -> int:
        with self._lock:
            blob = self._blobs.get(shard_id)
            return len(blob) if blob is not None else \
                self.base.shard_nbytes(shard_id)

    def read_bloom(self, shard_id: int) -> BloomFilter:
        with self._lock:
            bloom = self._blooms.get(shard_id)
            if bloom is None:
                return self.base.read_bloom(shard_id)
            self.io.add_read(bloom.nbytes())
            return bloom

    # -- epochs -------------------------------------------------------------
    def epoch(self) -> int:
        return self._epoch

    def shard_epoch(self, shard_id: int) -> int:
        return self._shard_epoch.get(shard_id, 0)

    def dirty_shards(self) -> list[int]:
        """Shards whose merged view has not yet been compacted into the base."""
        with self._lock:
            return sorted(self._merged)

    def delta_nbytes(self) -> int:
        """Resident overlay bytes (decoded merged shards + canonical blobs)."""
        with self._lock:
            return sum(s.decoded_nbytes() for s in self._merged.values()) + \
                sum(len(b) for b in self._blobs.values())

    # -- incremental-recompute support --------------------------------------
    def affected_sources_since(self, since_epoch: int) -> np.ndarray | None:
        """Union of source vertices touched by commits after ``since_epoch``,
        or None when the epoch log no longer reaches back that far."""
        with self._lock:
            if since_epoch < self._log_floor:
                return None
            parts = [srcs for (e, srcs, _m) in self._log if e > since_epoch]
            if not parts:
                return np.zeros(0, dtype=np.int64)
            return np.unique(np.concatenate(parts))

    def monotone_since(self, since_epoch: int) -> bool:
        """True iff every commit after ``since_epoch`` only added relaxation
        opportunities for min-propagation apps (no deletes, no weight
        increases).  Conservative: unknown history → False."""
        with self._lock:
            if since_epoch >= self._epoch:
                return True
            if since_epoch < self._log_floor:
                return False
            return all(m for (e, _s, m) in self._log if e > since_epoch)

    # -- mutation ------------------------------------------------------------
    def apply(self, inserts=None, deletes=None, updates=None) -> int:
        """Commit one batch of edge edits; returns the new graph epoch.

        ``inserts``/``updates`` (synonyms — both upsert) take ``(src, dst)``
        or ``(src, dst, weight)`` arrays or triple iterables; ``deletes``
        takes ``(src, dst)`` pairs.  Within a batch the last edit of a
        ``(src, dst)`` key wins, with deletes ordered after upserts — a key
        both upserted and deleted in one batch ends up deleted.
        """
        ins_s, ins_d, ins_v = _as_edge_arrays(inserts)
        upd_s, upd_d, upd_v = _as_edge_arrays(updates)
        del_s, del_d, _ = _as_edge_arrays(deletes)
        ins_s = np.concatenate([ins_s, upd_s])
        ins_d = np.concatenate([ins_d, upd_d])
        ins_v = np.concatenate([ins_v, upd_v])
        if ins_s.size == 0 and del_s.size == 0:
            return self._epoch

        n = self.num_vertices
        for name, (s, d) in (("insert", (ins_s, ins_d)),
                             ("delete", (del_s, del_d))):
            if s.size and (s.min() < 0 or s.max() >= n or
                           d.min() < 0 or d.max() >= n):
                raise ValueError(
                    f"{name} endpoints must lie in [0, {n}): the vertex set "
                    "is fixed at DeltaGraphStore construction")

        with self._lock:
            # last-edit-wins dedup across the whole batch, deletes merged in
            # as NaN-valued upserts (keyed identically)
            keys = np.concatenate([ins_d * n + ins_s, del_d * n + del_s])
            vals = np.concatenate(
                [ins_v, np.full(del_s.size, np.nan, dtype=np.float32)])
            _, last = np.unique(keys[::-1], return_index=True)
            order = np.sort(keys.size - 1 - last)
            keys, vals = keys[order], vals[order]
            edit_s = (keys % n).astype(np.int64)
            edit_d = (keys // n).astype(np.int64)

            new_epoch = self._epoch + 1
            owner = np.searchsorted(self._intervals, edit_d,
                                    side="right") - 1
            affected, monotone = [], True
            for p in np.unique(owner):
                sel = owner == p
                aff_p, mono_p = self._merge_shard(
                    int(p), edit_s[sel], edit_d[sel], keys[sel], vals[sel])
                affected.append(aff_p)
                monotone = monotone and mono_p
                self._shard_epoch[int(p)] = new_epoch
            self._prop["num_edges"] = int(self._in_deg.sum())
            self._epoch = new_epoch
            self._log.append(
                (new_epoch,
                 np.unique(np.concatenate(affected)) if affected
                 else np.zeros(0, dtype=np.int64),
                 monotone))
            if len(self._log) > _EPOCH_LOG_CAP:
                self._log_floor = self._log[0][0]
                del self._log[0]

            if self.delta_budget_bytes and \
                    self.delta_nbytes() > self.delta_budget_bytes:
                if not self.auto_compact:
                    raise DeltaBudgetError(
                        f"overlay holds {self.delta_nbytes()} bytes > "
                        f"GRAPHMP_DELTA_BUDGET={self.delta_budget_bytes} "
                        "and auto-compact is off")
                from repro_torch.graph.compact import compact
                compact(self)
            return self._epoch

    def _merge_shard(self, p: int, edit_s, edit_d, edit_keys, edit_vals):
        """Apply one shard's deduped edits to its current merged view.

        Returns ``(affected_sources, monotone)`` for the epoch log.  Must be
        called under the lock with ``edit_keys`` already deduplicated
        (last-edit-wins) and NaN values marking deletes.
        """
        n = self.num_vertices
        cur = self._merged.get(p)
        if cur is None:
            cur = self.base.read_shard(p)
        local, srcs, vals = _ell_to_csr_triples(cur)
        start = cur.start_vertex
        base_keys = (local + start) * n + srcs

        # copies of each edited key already present (degree/monotone math)
        uk, uc = np.unique(base_keys, return_counts=True)
        pos = np.searchsorted(uk, edit_keys)
        pos_ok = pos < uk.size
        present = np.zeros(edit_keys.size, dtype=np.int64)
        present[pos_ok] = np.where(uk[pos[pos_ok]] == edit_keys[pos_ok],
                                   uc[pos[pos_ok]], 0)
        # smallest existing weight per edited key (monotonicity check)
        old_min = np.full(edit_keys.size, np.inf, dtype=np.float64)
        if base_keys.size:
            o = np.argsort(base_keys, kind="stable")
            bk, bv = base_keys[o], vals[o]
            grp = np.searchsorted(bk, edit_keys)
            for i in np.nonzero(present > 0)[0]:
                lo = grp[i]
                old_min[i] = bv[lo:lo + present[i]].min()

        is_del = np.isnan(edit_vals)
        # drop every base copy of every edited key, then append the upserts
        keep = ~np.isin(base_keys, edit_keys)
        app = ~is_del
        m_local = np.concatenate([local[keep], edit_d[app] - start])
        m_srcs = np.concatenate([srcs[keep], edit_s[app]])
        m_vals = np.concatenate([vals[keep],
                                 edit_vals[app].astype(np.float32)])
        order = np.argsort(m_local, kind="stable")  # kept first, then new
        m_local, m_srcs, m_vals = m_local[order], m_srcs[order], m_vals[order]

        rows = cur.end_vertex - cur.start_vertex
        counts = np.bincount(m_local, minlength=rows)
        csr = CSRShard(
            shard_id=p, start_vertex=cur.start_vertex,
            end_vertex=cur.end_vertex,
            row=np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
            col=m_srcs.astype(np.int32), val=m_vals.astype(np.float32))
        merged = csr_to_ell(csr, max_width=self._ell_max_width(),
                            lane=self._lane)
        vd = self._val_dtype()
        if vd != "float32" and self._prop.get("weighted"):
            merged = quantize_shard(merged, vd)  # keep the store's edge dtype
        blob = pack_shard_npz(merged)

        # degrees + shard meta + epoch-log ingredients
        edge_delta = app.astype(np.int64) - present
        np.add.at(self._in_deg, edit_d, edge_delta)
        np.add.at(self._out_deg, edit_s, edge_delta)
        meta = self._prop["shards"][p]
        meta["rows"], meta["width"] = (int(x) for x in merged.shape)
        meta["nnz"] = int(merged.nnz)
        base_bloom = self._blooms.get(p) or self.base.read_bloom(p)
        self._merged[p] = merged
        self._blobs[p] = blob
        self._blooms[p] = BloomFilter.build(
            merged.source_vertices(), num_bits=base_bloom.num_bits,
            num_hashes=base_bloom.num_hashes)

        deleted_existing = is_del & (present > 0)
        increased = app & (present > 0) & (edit_vals > old_min)
        monotone = not (deleted_existing.any() or bool(increased.any()))
        affected = edit_s[app]  # sources of upserts seed incremental runs
        return np.unique(affected), monotone

    # -- layout parameters ---------------------------------------------------
    def _ell_max_width(self) -> int:
        return int(self._prop.get("ell_max_width", 512))

    def _val_dtype(self) -> str:
        return str(self._prop.get("val_dtype", "float32"))

    def _infer_lane(self) -> int:
        """Layout lane: recorded by preprocess since the delta subsystem
        landed; older stores fall back to the gcd of shard widths (every
        width is a lane multiple, so the gcd reproduces a valid layout)."""
        lane = self._prop.get("lane")
        if lane:
            return int(lane)
        widths = [int(m["width"]) for m in self._prop["shards"]]
        return math.gcd(*widths) if widths else 128

    # -- compaction hook -----------------------------------------------------
    def _compacted(self) -> None:
        """Release overlay state after the base absorbed it.  Epochs are
        kept: shard content is unchanged by compaction, so cache entries
        stamped with the dirty epoch stay valid."""
        with self._lock:
            self._merged.clear()
            self._blobs.clear()
            self._blooms.clear()
