"""Dirty-shard compaction: fold a DeltaGraphStore overlay back into its base.

Only the shards mutated since the last compaction are rewritten — Bloom
filters and degree arrays included — so compaction cost scales with the
delta, not the graph:

  * npz directory (``GraphStore``): dirty ``shard_*.npz``/``bloom_*.npz``
    files are rewritten in place, then ``vertex_info.npz`` and
    ``property.json`` (the property rewrite also bumps its mtime, which is
    what tells the session's auto-repack check that any stale ``.gmpk``
    sibling needs repacking).
  * packed file (``PackedGraphStore``): new segments for the dirty shards
    are **appended** after the current header, a new tail header is written,
    and finally the 16-byte preamble is repointed — crash-safe ordering (the
    file parses with the old header until the final small write).  The old
    header and superseded segments become dead bytes, reported in the
    ``CompactionReport``; a full ``pack_graph`` rewrite reclaims them.
  * memory (``MemoryGraphStore``): the merged views are swapped in.

Compaction does **not** bump the graph epoch and does not reset per-shard
epochs: shard *content* is unchanged, so cache entries and memo results
stamped with the current epoch remain valid across it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np

from repro_torch.graph.delta import DeltaGraphStore


@dataclasses.dataclass(frozen=True)
class CompactionReport:
    epoch: int                    # graph epoch the base now reflects
    backend: str                  # base store class name
    shards_rewritten: tuple[int, ...]
    bytes_written: int            # bytes pushed into the base store
    dead_bytes: int               # superseded bytes left behind (packed only)
    seconds: float


def _json_ready(obj):
    """Deep-copy ``obj`` into plain-JSON types (property.json / header)."""
    if isinstance(obj, dict):
        return {k: _json_ready(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_ready(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def compact(store: DeltaGraphStore) -> CompactionReport:
    """Rewrite the base's dirty shards from ``store``'s merged views, then
    release the overlay memory.  Safe to call with no dirty shards (no-op
    report).  The caller must ensure no run is mid-flight (GraphService
    drains; the engine's epoch pin turns a violation into an error, but
    compaction itself does not change shard content so it never trips it).
    """
    from repro_torch.graph.packed import PackedGraphStore
    from repro_torch.graph.storage import GraphStore
    from repro_torch.graph.memory import MemoryGraphStore

    t0 = time.perf_counter()
    with store._lock:
        dirty = tuple(sorted(store._merged))
        base = store.base
        backend = type(base).__name__
        if not dirty:
            return CompactionReport(epoch=store.epoch(), backend=backend,
                                    shards_rewritten=(), bytes_written=0,
                                    dead_bytes=0,
                                    seconds=time.perf_counter() - t0)
        if isinstance(base, GraphStore):
            written, dead = _compact_npz(store, base, dirty)
        elif isinstance(base, PackedGraphStore):
            written, dead = _compact_packed(store, base, dirty)
        elif isinstance(base, MemoryGraphStore):
            written, dead = _compact_memory(store, base, dirty)
        else:
            raise TypeError(
                f"cannot compact into a {backend}: no rewrite support "
                "(wrap an npz/packed/memory base, or pack_graph the overlay "
                "to a fresh file instead)")
        store._compacted()
        return CompactionReport(epoch=store.epoch(), backend=backend,
                                shards_rewritten=dirty, bytes_written=written,
                                dead_bytes=dead,
                                seconds=time.perf_counter() - t0)


def _compact_npz(store: DeltaGraphStore, base, dirty) -> tuple[int, int]:
    written0 = base.io.written
    for p in dirty:
        base.write_shard(store._merged[p])
        base.write_bloom(p, store._blooms[p])
    base.write_vertex_info(store._in_deg, store._out_deg)
    base.write_properties(_json_ready(store._prop))
    return base.io.written - written0, 0


def _seg_nbytes(ref: dict) -> int:
    shape = tuple(ref["shape"])
    count = int(np.prod(shape)) if shape else 1
    return count * np.dtype(ref["dtype"]).itemsize


def _compact_packed(store: DeltaGraphStore, base, dirty) -> tuple[int, int]:
    from repro_torch.graph.packed import MAGIC, _write_segment

    header = json.loads(json.dumps(base._header))  # deep copy
    # superseded bytes: the old tail header plus every segment being replaced
    dead = len(json.dumps(base._header, sort_keys=True).encode())
    for key in ("in_degree", "out_degree"):
        dead += _seg_nbytes(header["vertex_info"][key])
    for p in dirty:
        dead += _seg_nbytes(header["blooms"][p]["bits"])
        for key in ("cols", "vals", "row_map"):
            dead += _seg_nbytes(header["shards"][p][key])

    with open(base.path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        end0 = f.tell()
        header["vertex_info"] = {
            "in_degree": _write_segment(f, store._in_deg),
            "out_degree": _write_segment(f, store._out_deg)}
        for p in dirty:
            s = store._merged[p]
            b = store._blooms[p]
            header["blooms"][p] = {"bits": _write_segment(f, b.bits),
                                   "num_bits": b.num_bits,
                                   "num_hashes": b.num_hashes}
            header["shards"][p] = {
                "start": int(s.start_vertex), "end": int(s.end_vertex),
                "nnz": int(s.nnz), "nbytes": len(store._blobs[p]),
                "val_scale": float(s.val_scale), "val_zero": float(s.val_zero),
                "cols": _write_segment(f, s.cols),
                "vals": _write_segment(f, s.vals),
                "row_map": _write_segment(f, s.row_map)}
        header["properties"] = _json_ready(store._prop)
        blob = json.dumps(header, sort_keys=True).encode()
        hdr_off = f.tell()
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())  # data durable before the preamble repoints
        f.seek(len(MAGIC))
        f.write(hdr_off.to_bytes(8, "little"))
        f.write(len(blob).to_bytes(8, "little"))
        f.flush()
        written = f.seek(0, os.SEEK_END) - end0
    base.io.add_written(written)
    base.remap()
    return written, dead


def _compact_memory(store: DeltaGraphStore, base, dirty) -> tuple[int, int]:
    nbytes = {p: len(store._blobs[p]) for p in dirty}
    base._apply_compaction(
        shards={p: store._merged[p] for p in dirty},
        blooms={p: store._blooms[p] for p in dirty},
        nbytes=nbytes,
        vertex_info=(store._in_deg.copy(), store._out_deg.copy()),
        properties=_json_ready(store._prop))
    written = sum(nbytes.values())
    base.io.add_written(written)  # RAM swap, charged at canonical blob size
    return written, 0
