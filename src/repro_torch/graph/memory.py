"""In-memory backend: the whole graph RAM-resident (tests/benchmarks).

A ``MemoryGraphStore`` serves shards from host memory with zero real I/O —
the upper bound every disk backend is measured against (paper Figs. 9-10's
"GraphMP vs in-memory systems" comparison).  It still *accounts* every
``read_shard`` at the shard's canonical nbytes so runs report the same
"disk" byte totals as the npz/packed backends: benchmark deltas then isolate
the storage medium, not the bookkeeping.

Build one from any other source with ``MemoryGraphStore.from_source(...)``
(one full pass, charged to that source's counters), or construct directly
from shards for synthetic tests.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.shards import ELLShard
import dataclasses

from repro_torch.graph.source import (BytesCounter, ShardSource,
                                      ShardSourceBase, pack_shard_npz,
                                      validate_properties)


def _materialized(shard: ELLShard) -> ELLShard:
    """Own the arrays: a shard read from the packed backend is a set of
    mmap views, and a 'RAM-resident' store holding views would stay
    disk-backed (pages droppable under pressure, mmap pinned forever)."""
    if shard.cols.flags.writeable:
        return shard  # already owned (npz / direct construction)
    return dataclasses.replace(shard, cols=np.array(shard.cols),
                               vals=np.array(shard.vals),
                               row_map=np.array(shard.row_map))


class MemoryGraphStore(ShardSourceBase):
    def __init__(self, properties: dict, vertex_info: tuple[np.ndarray, np.ndarray],
                 shards: list[ELLShard], blooms: list[BloomFilter],
                 shard_nbytes: list[int] | None = None,
                 path: str = "<memory>"):
        self._prop = validate_properties(dict(properties), "MemoryGraphStore")
        if len(shards) != self.num_shards or len(blooms) != self.num_shards:
            raise ValueError(
                f"properties claim {self.num_shards} shards, got "
                f"{len(shards)} shards / {len(blooms)} blooms")
        self._vertex_info = vertex_info
        self._shards = list(shards)
        self._blooms = list(blooms)
        # canonical per-shard accounting size; derived from the npz blob when
        # the caller has no on-disk sizes to carry over
        self._nbytes = ([int(b) for b in shard_nbytes]
                        if shard_nbytes is not None
                        else [len(pack_shard_npz(s)) for s in shards])
        self.path = path
        self.io = BytesCounter()

    @classmethod
    def from_source(cls, source: ShardSource) -> "MemoryGraphStore":
        """Load every shard/bloom of another source into RAM (one full pass)."""
        n = int(source.properties["num_shards"])
        return cls(
            properties=source.properties,
            vertex_info=source.read_vertex_info(),
            shards=[_materialized(source.read_shard(p)) for p in range(n)],
            blooms=[source.read_bloom(p) for p in range(n)],
            shard_nbytes=[int(source.shard_nbytes(p)) for p in range(n)],
            path=f"<memory:{getattr(source, 'path', '?')}>",
        )

    @property
    def properties(self) -> dict:
        return self._prop

    def read_vertex_info(self) -> tuple[np.ndarray, np.ndarray]:
        in_deg, out_deg = self._vertex_info
        self.io.add_read(in_deg.nbytes + out_deg.nbytes)
        return in_deg, out_deg

    def read_shard(self, shard_id: int) -> ELLShard:
        self.io.add_read(self.shard_nbytes(shard_id))
        return self._shards[shard_id]

    def read_shard_bytes(self, shard_id: int) -> bytes:
        self.io.add_read(self.shard_nbytes(shard_id))
        return pack_shard_npz(self._shards[shard_id])

    def shard_nbytes(self, shard_id: int) -> int:
        return self._nbytes[shard_id]

    def read_bloom(self, shard_id: int) -> BloomFilter:
        bloom = self._blooms[shard_id]
        self.io.add_read(bloom.nbytes())
        return bloom

    def _apply_compaction(self, shards: dict[int, ELLShard],
                          blooms: dict[int, BloomFilter],
                          nbytes: dict[int, int],
                          vertex_info: tuple[np.ndarray, np.ndarray],
                          properties: dict) -> None:
        """Absorb a DeltaGraphStore overlay (repro_torch.graph.compact): swap in
        the merged views of the dirty shards and the updated graph-level
        state.  Clean shards keep their identity (views stay valid)."""
        for p, shard in shards.items():
            self._shards[p] = _materialized(shard)
            self._blooms[p] = blooms[p]
            self._nbytes[p] = int(nbytes[p])
        self._vertex_info = vertex_info
        self._prop = validate_properties(dict(properties), "MemoryGraphStore")
