"""Three-step preprocessing pipeline (paper §2.2), with real disk I/O.

Step 1: scan the edge list, count in/out-degrees, compute vertex intervals
        with Algorithm 1 (cost: D|E| read).
Step 2: re-scan the edge list, append each edge to its owning shard's scratch
        file by destination interval (D|E| read + D|E| write).
Step 3: per shard, sort by destination, emit CSR -> blocked-ELL, persist, and
        build the shard's Bloom filter over source vertices
        (D|E| read + ~D|E| write).

Total ~5 D|E| of I/O — matching the paper's Table 3 row for VSW.  One
preprocessing run serves every application (PR/SSSP/CC share the store).
"""
from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from repro_torch.core.bloom import BloomFilter
from repro_torch.core.shards import (EDGE_VAL_DTYPES, CSRShard, compute_intervals,
                               csr_to_ell, quantize_shard)
from repro_torch.graph.storage import GraphStore, iter_edge_list


def resolve_val_dtype(val_dtype: str | None) -> str:
    """Edge-value storage dtype: explicit arg > GRAPHMP_EDGE_DTYPE > float32."""
    if val_dtype is None:
        val_dtype = os.environ.get("GRAPHMP_EDGE_DTYPE") or "float32"
    if val_dtype not in EDGE_VAL_DTYPES:
        raise ValueError(f"val_dtype must be one of {EDGE_VAL_DTYPES}, "
                         f"got {val_dtype!r}")
    return val_dtype


def _radix_key(keys: np.ndarray, bound: int) -> np.ndarray:
    """``keys`` (all in ``[0, bound)``) as the narrowest unsigned dtype
    that holds them: numpy's stable argsort of a 16-bit or narrower key
    is a radix sort, several times faster than on int64, and a stable
    order is the same whatever the algorithm."""
    if bound <= 1 << 8:
        return keys.astype(np.uint8)
    if bound <= 1 << 16:
        return keys.astype(np.uint16)
    return keys


def preprocess_graph(
    edge_list_dir: str,
    out_dir: str,
    threshold_edge_num: int = 1 << 20,
    ell_max_width: int = 512,
    bloom_fp_rate: float = 0.01,
    num_vertices: int | None = None,
    lane: int = 128,
    val_dtype: str | None = None,
) -> GraphStore:
    val_dtype = resolve_val_dtype(val_dtype)
    store = GraphStore(out_dir)
    t0 = time.time()

    # ---- step 1: degree scan + Algorithm 1 --------------------------------
    with open(Path(edge_list_dir) / "meta.json") as f:
        meta = json.load(f)
    n = int(num_vertices or meta["num_vertices"])
    in_deg = np.zeros(n, dtype=np.int64)
    out_deg = np.zeros(n, dtype=np.int64)
    n_edges = 0
    for src, dst, _ in iter_edge_list(edge_list_dir, store.io):
        in_deg += np.bincount(dst, minlength=n)
        out_deg += np.bincount(src, minlength=n)
        n_edges += src.shape[0]
    starts = compute_intervals(in_deg, threshold_edge_num)
    P = len(starts) - 1

    # ---- step 2: bucket edges into per-shard scratch files -----------------
    scratch_dir = Path(out_dir) / "scratch"
    scratch_dir.mkdir(parents=True, exist_ok=True)
    scratch = [open(scratch_dir / f"s{p:05d}.bin", "wb") for p in range(P)]
    weighted = bool(meta.get("weighted"))
    for src, dst, val in iter_edge_list(edge_list_dir, store.io):
        owner = np.searchsorted(starts, dst, side="right") - 1
        order = np.argsort(_radix_key(owner, P), kind="stable")
        owner_s, src_s, dst_s = owner[order], src[order], dst[order]
        val_s = val[order] if val is not None else None
        bounds = np.searchsorted(owner_s, np.arange(P + 1))
        for p in range(P):
            lo, hi = bounds[p], bounds[p + 1]
            if lo == hi:
                continue
            if weighted:
                rec = np.empty((hi - lo, 3), dtype=np.int64)
                rec[:, 0], rec[:, 1] = src_s[lo:hi], dst_s[lo:hi]
                rec[:, 2] = val_s[lo:hi].view(np.uint32).astype(np.int64)
            else:
                rec = np.stack([src_s[lo:hi], dst_s[lo:hi]], axis=1)
            buf = rec.tobytes()
            scratch[p].write(buf)
            store.io.add_written(len(buf))
    for f in scratch:
        f.close()

    # ---- step 3: sort, CSR -> ELL, persist, Bloom ---------------------------
    # one shard a task, on a few threads (numpy's sorts, gathers and the
    # writes release the GIL); each shard's bytes depend on it alone
    bloom_bits = BloomFilter.sized_for(int(threshold_edge_num), bloom_fp_rate)

    def build_shard(p: int) -> dict:
        sp = scratch_dir / f"s{p:05d}.bin"
        width = 3 if weighted else 2
        raw = np.fromfile(sp, dtype=np.int64).reshape(-1, width)
        store.io.add_read(sp.stat().st_size)
        lo, hi = int(starts[p]), int(starts[p + 1])
        dst_local = raw[:, 1] - lo
        order = np.argsort(_radix_key(dst_local, hi - lo), kind="stable")
        src_sorted = raw[order, 0]
        counts = np.bincount(dst_local, minlength=hi - lo)
        row = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        vals = None
        if weighted:
            vals = raw[order, 2].astype(np.uint32).view(np.float32)
        csr = CSRShard(
            shard_id=p, start_vertex=lo, end_vertex=hi,
            row=row, col=src_sorted.astype(np.int32), val=vals,
        )
        ell = csr_to_ell(csr, max_width=ell_max_width, lane=lane)
        if weighted and val_dtype != "float32":
            # quantize per shard (scale/zero recorded in the blob); unweighted
            # graphs keep unit float32 vals — the npz codec already elides them
            ell = quantize_shard(ell, val_dtype)
        store.write_shard(ell)
        store.write_bloom(p, BloomFilter.build(ell.source_vertices(), num_bits=bloom_bits))
        sp.unlink()
        return {"rows": int(ell.shape[0]), "width": int(ell.shape[1]), "nnz": ell.nnz}

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        shard_meta = list(ex.map(build_shard, range(P)))
    scratch_dir.rmdir()

    store.write_vertex_info(in_deg, out_deg)
    store.write_properties(
        {
            "num_vertices": n,
            "num_edges": int(n_edges),
            "num_shards": P,
            "intervals": [int(s) for s in starts],
            "weighted": weighted,
            "val_dtype": val_dtype if weighted else "float32",
            "threshold_edge_num": int(threshold_edge_num),
            "ell_max_width": int(ell_max_width),
            "lane": int(lane),  # DeltaGraphStore re-lays dirty shards with it
            "shards": shard_meta,
            "preprocess_seconds": time.time() - t0,
        }
    )
    return store
