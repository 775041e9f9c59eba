"""Packed single-file backend: one mmap'd file, zero-copy shard views.

The npz-per-shard directory pays a zip-parse plus an array copy on every
shard miss.  The packed format removes both: all arrays live as raw
little-endian segments inside ONE file, 64-byte aligned, described by a JSON
header — ``read_shard`` returns ``ELLShard`` whose cols/vals/row_map are
**views into the shared mmap** (no parse, no copy; the OS pages data in on
first touch, which the ShardPipeline moves off the critical path).

File layout::

    offset 0   magic  b"GMPACK01"
    offset 8   uint64 LE header offset
    offset 16  uint64 LE header length
    offset 24  64-byte-aligned raw array segments (C-order tobytes)
    tail       header JSON:
                 properties      — carried verbatim from the source
                 vertex_info     — segment refs for in/out degree
                 blooms[p]       — segment ref + num_bits/num_hashes
                 shards[p]       — segment refs for cols/vals/row_map,
                                   start/end/nnz, canonical nbytes

``nbytes`` per shard is the **canonical npz-blob size recorded at pack
time**, so disk-byte accounting is identical to the npz backend serving the
same graph (Table-3 figures stay comparable across backends).  Unlike the
npz format, vals are always materialized — the packed file trades a little
disk for strictly zero-copy reads.

Convert a preprocessed directory with::

    python -m repro_torch.graph.pack GRAPH_DIR [OUT_FILE]
"""
from __future__ import annotations

import json
import mmap
import os
from pathlib import Path

import numpy as np

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.shards import ELLShard
from repro_torch.graph.source import (BytesCounter, MissingGraphError,
                                      ShardSource, ShardSourceBase,
                                      pack_shard_npz, validate_properties)

MAGIC = b"GMPACK01"
_PREAMBLE = len(MAGIC) + 16  # magic + header offset + header length
ALIGN = 64
PACKED_SUFFIX = ".gmpk"
DEFAULT_PACKED_NAME = "packed" + PACKED_SUFFIX


def is_packed_file(path: str | os.PathLike) -> bool:
    p = Path(path)
    if not p.is_file():
        return False
    with open(p, "rb") as f:
        return f.read(len(MAGIC)) == MAGIC


def _write_segment(f, arr: np.ndarray) -> dict:
    f.write(b"\0" * ((-f.tell()) % ALIGN))
    offset = f.tell()
    arr = np.ascontiguousarray(arr)
    f.write(arr.tobytes())
    return {"offset": offset, "dtype": arr.dtype.str, "shape": list(arr.shape)}


def pack_graph(source: ShardSource | str | os.PathLike,
               out_path: str | os.PathLike | None = None) -> Path:
    """Convert any ShardSource into a packed single file; returns its path."""
    # local import: avoids an import cycle
    from repro_torch.graph.storage import GraphStore

    if isinstance(source, (str, os.PathLike)):
        source = GraphStore(source)
    if out_path is None:
        base = getattr(source, "path", None)
        if base is None or not Path(base).is_dir():
            raise ValueError("out_path is required for a directory-less source")
        out_path = Path(base) / DEFAULT_PACKED_NAME
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    header: dict = {"properties": dict(source.properties)}
    # per-process tmp name: concurrent auto-packs of one directory must not
    # interleave writes; last os.replace wins with a complete file either way
    tmp = out_path.with_name(f".{out_path.name}.{os.getpid()}.tmp")
    try:
        _write_packed(source, tmp, header)
        os.replace(tmp, out_path)
    except BaseException:
        tmp.unlink(missing_ok=True)  # no orphaned multi-GB temp on failure
        raise
    return out_path


def _write_packed(source: ShardSource, tmp: Path, header: dict) -> None:
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(bytes(16))  # header offset + length, patched at the end
        in_deg, out_deg = source.read_vertex_info()
        header["vertex_info"] = {"in_degree": _write_segment(f, in_deg),
                                 "out_degree": _write_segment(f, out_deg)}
        header["blooms"] = []
        for p in range(source.num_shards):
            b = source.read_bloom(p)
            header["blooms"].append({"bits": _write_segment(f, b.bits),
                                     "num_bits": b.num_bits,
                                     "num_hashes": b.num_hashes})
        header["shards"] = []
        for p in range(source.num_shards):
            s = source.read_shard(p)
            header["shards"].append({
                "start": int(s.start_vertex), "end": int(s.end_vertex),
                "nnz": int(s.nnz), "nbytes": int(source.shard_nbytes(p)),
                "val_scale": float(s.val_scale), "val_zero": float(s.val_zero),
                "cols": _write_segment(f, s.cols),
                "vals": _write_segment(f, s.vals),
                "row_map": _write_segment(f, s.row_map),
            })
        blob = json.dumps(header, sort_keys=True).encode()
        hdr_off = f.tell()
        f.write(blob)
        f.seek(len(MAGIC))
        f.write(hdr_off.to_bytes(8, "little"))
        f.write(len(blob).to_bytes(8, "little"))


class PackedGraphStore(ShardSourceBase):
    """Read-only ShardSource over one packed file (mmap'd once, shared)."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.io = BytesCounter()
        if not self.path.is_file():
            raise MissingGraphError(
                f"{str(self.path)!r} is not a packed graph file; create one "
                "with `python -m repro_torch.graph.pack GRAPH_DIR`")
        with open(self.path, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic != MAGIC:
                raise MissingGraphError(
                    f"{str(self.path)!r} is not a packed graph "
                    f"(bad magic {magic!r}); create one with "
                    "`python -m repro_torch.graph.pack GRAPH_DIR`")
            hdr_off = int.from_bytes(f.read(8), "little")
            hdr_len = int.from_bytes(f.read(8), "little")
            try:
                f.seek(hdr_off)
                header = json.loads(f.read(hdr_len))
            except (OSError, UnicodeDecodeError, json.JSONDecodeError) as exc:
                raise MissingGraphError(
                    f"{str(self.path)!r} has a corrupt or truncated packed "
                    f"header ({exc}); re-run `python -m repro_torch.graph.pack`"
                ) from exc
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._header = header
        self._retired: list[mmap.mmap] = []
        self._prop = validate_properties(dict(header["properties"]),
                                         repr(str(self.path)))

    @property
    def properties(self) -> dict:
        return self._prop

    def _view(self, ref: dict) -> np.ndarray:
        dtype = np.dtype(ref["dtype"])
        shape = tuple(ref["shape"])
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(self._mm, dtype=dtype, count=count,
                            offset=int(ref["offset"]))
        return arr.reshape(shape)

    def read_vertex_info(self) -> tuple[np.ndarray, np.ndarray]:
        # copies, not views: vertex info and blooms live for a whole session,
        # and long-lived views would pin the mmap open forever (close() path);
        # zero-copy is reserved for the hot per-iteration shard reads
        vi = self._header["vertex_info"]
        in_deg = np.array(self._view(vi["in_degree"]))
        out_deg = np.array(self._view(vi["out_degree"]))
        self.io.add_read(in_deg.nbytes + out_deg.nbytes)
        return in_deg, out_deg

    def _shard_view(self, shard_id: int) -> ELLShard:
        rec = self._header["shards"][shard_id]
        return ELLShard(
            shard_id=shard_id,
            start_vertex=int(rec["start"]),
            end_vertex=int(rec["end"]),
            nnz=int(rec["nnz"]),
            cols=self._view(rec["cols"]),
            vals=self._view(rec["vals"]),
            row_map=self._view(rec["row_map"]),
            val_scale=float(rec.get("val_scale", 1.0)),
            val_zero=float(rec.get("val_zero", 0.0)),
        )

    def read_shard(self, shard_id: int) -> ELLShard:
        self.io.add_read(self.shard_nbytes(shard_id))
        return self._shard_view(shard_id)

    def read_shard_bytes(self, shard_id: int) -> bytes:
        """Canonical npz blob, re-serialized from the mmap'd views."""
        self.io.add_read(self.shard_nbytes(shard_id))
        return pack_shard_npz(self._shard_view(shard_id))

    def shard_nbytes(self, shard_id: int) -> int:
        return int(self._header["shards"][shard_id]["nbytes"])

    def read_bloom(self, shard_id: int) -> BloomFilter:
        rec = self._header["blooms"][shard_id]
        bits = np.array(self._view(rec["bits"]))  # copy: see read_vertex_info
        self.io.add_read(bits.nbytes)
        return BloomFilter(bits=bits, num_bits=int(rec["num_bits"]),
                           num_hashes=int(rec["num_hashes"]))

    def remap(self) -> None:
        """Re-read the preamble/header and re-mmap the file after an in-place
        append (dirty-shard compaction).  The previous mapping is *retired*,
        not closed: shard views handed out before the remap may still alias
        its pages, and those stay valid because old segments are never
        overwritten — compaction only appends and repoints the header."""
        with open(self.path, "rb") as f:
            f.seek(len(MAGIC))
            hdr_off = int.from_bytes(f.read(8), "little")
            hdr_len = int.from_bytes(f.read(8), "little")
            f.seek(hdr_off)
            header = json.loads(f.read(hdr_len))
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._retired.append(self._mm)
        self._mm = mm
        self._header = header
        self._prop = validate_properties(dict(header["properties"]),
                                         repr(str(self.path)))

    def close(self) -> None:
        for mm in self._retired:
            try:
                mm.close()
            except BufferError:  # a live view still pins it; main close decides
                pass
        self._mm.close()
