"""npz-directory backend: the paper's property file + vertex info + shard files.

Layout of a preprocessed graph directory:

  property.json          — |V|, |E|, P, intervals, weighted, threshold (paper §2.2)
  vertex_info.npz        — in_degree, out_degree arrays
  bloom_<p>.npz          — per-shard Bloom filter over source vertices (§2.4.1)
  shard_<p>.npz          — blocked-ELL arrays (cols, vals, row_map) + metadata

``GraphStore`` is one implementation of the ``ShardSource`` protocol
(graph/source.py); the single-file mmap'd ``PackedGraphStore`` and the
RAM-resident ``MemoryGraphStore`` are the others.  Every read/write here is a
real file operation; the thread-safe ``BytesCounter`` instruments the store so
benchmarks report actual disk bytes, the paper's primary metric (Table 3).
"""
from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.shards import ELLShard
from repro_torch.graph.source import (BytesCounter, MissingGraphError,
                                ShardSourceBase, pack_shard_npz,
                                unpack_shard_npz, validate_properties)

__all__ = ["BytesCounter", "GraphStore", "MissingGraphError",
           "write_edge_list", "iter_edge_list"]


class GraphStore(ShardSourceBase):
    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.io = BytesCounter()
        self._prop: dict | None = None

    # ---- property file -------------------------------------------------
    @property
    def properties(self) -> dict:
        if self._prop is None:
            p = self.path / "property.json"
            if not p.is_file():
                raise MissingGraphError(
                    f"{str(self.path)!r} is not a preprocessed graph "
                    "(no property.json); run "
                    "repro_torch.graph.preprocess.preprocess_graph first")
            try:
                with open(p) as f:
                    prop = json.load(f)
            except json.JSONDecodeError as exc:
                raise MissingGraphError(
                    f"{str(p)!r} is not valid JSON ({exc}); the graph "
                    "directory is corrupt or half-written — re-run "
                    "preprocess_graph") from exc
            self._prop = validate_properties(prop, repr(str(self.path)))
        return self._prop

    def write_properties(self, prop: dict) -> None:
        self.path.mkdir(parents=True, exist_ok=True)
        tmp = self.path / "property.json.tmp"
        with open(tmp, "w") as f:
            json.dump(prop, f)
        os.replace(tmp, self.path / "property.json")
        self._prop = prop

    # ---- vertex info ----------------------------------------------------
    def write_vertex_info(self, in_degree: np.ndarray, out_degree: np.ndarray) -> None:
        p = self.path / "vertex_info.npz"
        np.savez(p, in_degree=in_degree, out_degree=out_degree)
        self.io.add_written(p.stat().st_size)

    def read_vertex_info(self) -> tuple[np.ndarray, np.ndarray]:
        p = self.path / "vertex_info.npz"
        with np.load(p) as z:
            self.io.add_read(p.stat().st_size)
            return z["in_degree"], z["out_degree"]

    # ---- shards ----------------------------------------------------------
    def shard_path(self, shard_id: int) -> Path:
        return self.path / f"shard_{shard_id:05d}.npz"

    def write_shard(self, shard: ELLShard) -> None:
        blob = pack_shard_npz(shard)
        self.shard_path(shard.shard_id).write_bytes(blob)
        self.io.add_written(len(blob))

    def read_shard(self, shard_id: int) -> ELLShard:
        return unpack_shard_npz(shard_id, self.read_shard_bytes(shard_id))

    def read_shard_bytes(self, shard_id: int) -> bytes:
        """Canonical npz blob — here that is exactly the file's bytes."""
        data = self.shard_path(shard_id).read_bytes()
        self.io.add_read(len(data))
        return data

    def shard_nbytes(self, shard_id: int) -> int:
        return self.shard_path(shard_id).stat().st_size

    # ---- bloom filters ----------------------------------------------------
    def write_bloom(self, shard_id: int, bloom: BloomFilter) -> None:
        p = self.path / f"bloom_{shard_id:05d}.npz"
        np.savez(p, bits=bloom.bits, meta=np.array([bloom.num_bits, bloom.num_hashes]))
        self.io.add_written(p.stat().st_size)

    def read_bloom(self, shard_id: int) -> BloomFilter:
        p = self.path / f"bloom_{shard_id:05d}.npz"
        self.io.add_read(p.stat().st_size)
        with np.load(p) as z:
            meta = z["meta"]
            return BloomFilter(bits=z["bits"], num_bits=int(meta[0]), num_hashes=int(meta[1]))


# ---- raw edge-list files (preprocessing input) -----------------------------
def write_edge_list(path: str | os.PathLike, chunks, weighted: bool = False,
                    seed: int = 0, num_vertices: int | None = None) -> dict:
    """Write a binary edge list (.npy pair files per chunk) — the 'CSV' stand-in.

    Returns {num_vertices, num_edges, files}.  Using raw int64 binary instead
    of CSV keeps preprocessing benchmarks about I/O + layout, not atoi().
    """
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_edges = 0
    max_v = -1
    files = []
    for i, (src, dst) in enumerate(chunks):
        arr = np.stack([src, dst]).astype(np.int64)
        f = path / f"edges_{i:05d}.npy"
        np.save(f, arr)
        files.append(f.name)
        if weighted:
            w = rng.random(src.shape[0]).astype(np.float32) * 9 + 1
            np.save(path / f"weights_{i:05d}.npy", w)
        n_edges += src.shape[0]
        max_v = max(max_v, int(src.max(initial=-1)), int(dst.max(initial=-1)))
    meta = {"num_vertices": max(max_v + 1, num_vertices or 0),
            "num_edges": n_edges, "files": files, "weighted": weighted}
    with open(path / "meta.json", "w") as f:
        json.dump(meta, f)
    return meta


def iter_edge_list(path: str | os.PathLike, io: BytesCounter | None = None):
    """Yield (src, dst, val|None) chunks from a binary edge list directory."""
    path = Path(path)
    with open(path / "meta.json") as f:
        meta = json.load(f)
    for name in meta["files"]:
        p = path / name
        arr = np.load(p)
        if io is not None:
            io.add_read(p.stat().st_size)
        w = None
        if meta.get("weighted"):
            wp = path / name.replace("edges_", "weights_")
            w = np.load(wp)
            if io is not None:
                io.add_read(wp.stat().st_size)
        yield arr[0], arr[1], w
