"""ShardSource: the storage-backend protocol the engine and cache talk to.

GraphMP's data path only ever needs five things from storage — decoded
shards, raw shard blobs, shard sizes, Bloom filters, and byte accounting —
so that surface IS the protocol.  Everything above it (``CompressedShardCache``,
``ShardPipeline``, ``VSWEngine``, ``GraphSession``) is backend-agnostic;
backends below it ship in three flavours:

  * ``repro_torch.graph.storage.GraphStore`` — the npz-per-shard directory
  * ``repro_torch.graph.packed.PackedGraphStore`` — one mmap'd file,
    zero-copy views
  * ``repro_torch.graph.memory.MemoryGraphStore`` — RAM-resident
    (tests/benchmarks)

``repro_torch.graph.delta.DeltaGraphStore`` wraps any of them in a mutable
overlay.

Disk-byte accounting (the paper's Table-3 metric) is **canonical**: every
backend charges a shard read at the shard's canonical npz-blob size, so the
reported byte counts are identical whichever backend served the run — figures
stay comparable across backends and prefetch depths.  ``BytesCounter`` is
thread-safe because the ``ShardPipeline`` fetches from background threads.
"""
from __future__ import annotations

import io as _io
import threading
from typing import Iterable, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.shards import ELLShard


class MissingGraphError(FileNotFoundError):
    """Raised when a path is not a preprocessed graph (no/invalid property.json)."""


class ConcurrentMutationError(RuntimeError):
    """Raised when a run observes a graph epoch newer than the one it pinned
    at start — i.e. the store was mutated mid-run without draining the run
    first (``GraphService.apply_mutations`` drains; direct ``apply`` calls
    against a store with live runs do not)."""


_REQUIRED_PROPERTIES = ("num_vertices", "num_edges", "num_shards",
                        "intervals", "shards")


def validate_properties(prop: dict, where: str) -> dict:
    """Check a property dict has the keys every consumer relies on."""
    missing = [k for k in _REQUIRED_PROPERTIES if k not in prop]
    if missing:
        raise MissingGraphError(
            f"{where} is not a preprocessed graph: property.json lacks "
            f"{missing}; run repro_torch.graph.preprocess.preprocess_graph first")
    return prop


class BytesCounter:
    """Thread-safe read/written byte tally.

    Mutate through ``add_read``/``add_written`` (atomic under an internal
    lock — prefetch threads and the main loop share one counter).  The
    ``read``/``written`` attributes stay plain-readable, and their setters
    keep legacy ``counter.read += n`` call sites working (those are only
    atomic on a single thread; concurrent writers must use the adders).
    """

    __slots__ = ("_lock", "_read", "_written")

    def __init__(self, read: int = 0, written: int = 0):
        self._lock = threading.Lock()
        self._read = int(read)
        self._written = int(written)

    def add_read(self, n: int) -> None:
        with self._lock:
            self._read += int(n)

    def add_written(self, n: int) -> None:
        with self._lock:
            self._written += int(n)

    @property
    def read(self) -> int:
        return self._read

    @read.setter
    def read(self, value: int) -> None:
        with self._lock:
            self._read = int(value)

    @property
    def written(self) -> int:
        return self._written

    @written.setter
    def written(self, value: int) -> None:
        with self._lock:
            self._written = int(value)

    def reset(self) -> None:
        with self._lock:
            self._read = 0
            self._written = 0

    def __repr__(self) -> str:
        return f"BytesCounter(read={self.read}, written={self.written})"


# ---------------------------------------------------------------------------
# canonical shard serialization (npz blob) — shared by every backend + cache
# ---------------------------------------------------------------------------
def pack_shard_npz(shard: ELLShard) -> bytes:
    """Serialize a shard as the canonical npz blob (the on-disk npz format).

    Unweighted graphs need no val array (paper §2.2): vals are unit and
    reconstructed from the col mask on read.
    """
    buf = _io.BytesIO()
    mask = shard.cols >= 0
    unit = (shard.vals.dtype == np.float32
            and bool(np.array_equal(shard.vals, mask.astype(np.float32))))
    payload = dict(
        cols=shard.cols,
        row_map=shard.row_map,
        meta=np.array([shard.start_vertex, shard.end_vertex, shard.nnz,
                       int(unit)], dtype=np.int64),
    )
    if not unit:
        payload["vals"] = shard.vals
        if shard.vals.dtype != np.float32:
            # affine dequant params for quantized edge values; float64 so
            # the (float32-rounded) python floats round-trip exactly
            payload["qparams"] = np.array([shard.val_scale, shard.val_zero],
                                          dtype=np.float64)
    np.savez(buf, **payload)
    return buf.getvalue()


def unpack_shard_npz(shard_id: int, blob: bytes) -> ELLShard:
    with np.load(_io.BytesIO(blob)) as z:
        meta = z["meta"]
        cols = z["cols"]
        unit = len(meta) > 3 and bool(meta[3])
        vals = (cols >= 0).astype(np.float32) if unit else z["vals"]
        scale, zero = 1.0, 0.0
        if "qparams" in z.files:
            qp = z["qparams"]
            scale, zero = float(qp[0]), float(qp[1])
        return ELLShard(
            shard_id=shard_id,
            start_vertex=int(meta[0]),
            end_vertex=int(meta[1]),
            nnz=int(meta[2]),
            cols=cols,
            vals=vals,
            row_map=z["row_map"],
            val_scale=scale,
            val_zero=zero,
        )


# ---------------------------------------------------------------------------
# the protocol
# ---------------------------------------------------------------------------
@runtime_checkable
class ShardSource(Protocol):
    """Structural type of a storage backend (what the cache/engine require)."""

    io: BytesCounter

    @property
    def properties(self) -> dict: ...
    def read_vertex_info(self) -> tuple[np.ndarray, np.ndarray]: ...
    def read_shard(self, shard_id: int) -> ELLShard: ...
    def read_shard_bytes(self, shard_id: int) -> bytes: ...
    def shard_nbytes(self, shard_id: int) -> int: ...
    def read_bloom(self, shard_id: int) -> BloomFilter: ...
    def epoch(self) -> int: ...
    def shard_epoch(self, shard_id: int) -> int: ...


class ShardSourceBase:
    """Derived accessors shared by every backend (all come off ``properties``)."""

    io: BytesCounter

    @property
    def properties(self) -> dict:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def num_vertices(self) -> int:
        return int(self.properties["num_vertices"])

    @property
    def num_edges(self) -> int:
        return int(self.properties["num_edges"])

    @property
    def num_shards(self) -> int:
        return int(self.properties["num_shards"])

    @property
    def intervals(self) -> np.ndarray:
        return np.asarray(self.properties["intervals"], dtype=np.int64)

    def shard_ids(self) -> Iterable[int]:
        return range(self.num_shards)

    def total_shard_bytes(self) -> int:
        return sum(self.shard_nbytes(p) for p in self.shard_ids())

    def shard_nbytes(self, shard_id: int) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def read_bloom(self, shard_id: int) -> BloomFilter:  # pragma: no cover
        raise NotImplementedError

    def read_all_blooms(self) -> list[BloomFilter]:
        return [self.read_bloom(p) for p in self.shard_ids()]

    # -- mutability surface (frozen stores sit forever at epoch 0) ----------
    def epoch(self) -> int:
        """Monotonic commit counter; 0 means the graph has never mutated."""
        return 0

    def shard_epoch(self, shard_id: int) -> int:
        """Epoch at which this shard's content last changed (0 = pristine)."""
        return 0


# ---------------------------------------------------------------------------
# graph identity / staleness — one code path for the serve memo layer and the
# session's auto-repack check
# ---------------------------------------------------------------------------
def path_mtime_ns(path) -> int:
    """mtime of ``path`` in ns, or -1 when it does not exist."""
    import os

    try:
        return os.stat(str(path)).st_mtime_ns
    except OSError:
        return -1


def graph_token(store) -> tuple:
    """A hashable token that changes iff the graph content may have changed.

    Mutable stores version themselves with :meth:`ShardSource.epoch`; frozen
    on-disk stores fall back to the mtime of the backing file
    (``property.json`` for directories), preserving the pre-epoch behavior.
    Stores with neither identity get an object-identity token.
    """
    epoch_fn = getattr(store, "epoch", None)
    epoch = int(epoch_fn()) if callable(epoch_fn) else 0
    path = getattr(store, "path", None)
    ident = str(path) if path is not None else f"<store:{id(store)}>"
    if epoch > 0:
        return (ident, "epoch", epoch)
    if path is not None:
        import os

        probe = str(path)
        if os.path.isdir(probe):
            probe = os.path.join(probe, "property.json")
        mtime = path_mtime_ns(probe)
        if mtime >= 0:
            return (ident, "mtime", mtime)
    return ("unversioned", id(store))
