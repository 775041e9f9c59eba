"""Graph sharding: vertex intervals (Algorithm 1), CSR shards, blocked-ELL.

Faithful to the paper's §2.2:
  * vertices are split into P disjoint intervals; shard(i) holds every edge
    whose *destination* lies in interval i (pull-mode, single writer);
  * Algorithm 1 greedily cuts intervals so each shard holds at most
    ``threshold_edge_num`` edges (paper default: 20M edges ≈ 80MB);
  * edges inside a shard are grouped by destination and stored in CSR.

TPU adaptation (DESIGN.md §4): CSR rows are re-laid out as **blocked-ELL** —
``(rows, width)`` rectangles with lane-aligned width (multiple of 128) and
sentinel columns ``col < 0``.  Rows whose degree exceeds the shard's ELL
width are wrapped onto extra ELL rows mapped to the same destination vertex
(`row_map`), which is how we absorb power-law skew without padding the whole
shard to the max in-degree.  The reduce over duplicated rows re-applies the
semiring, preserving exact results for +, min.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

LANE = 128  # TPU lane width; ELL width is padded to a multiple of this.
SUBLANE = 8  # TPU sublane; ELL row count padded to a multiple of this.

# Edge-value storage dtypes (GRAPHMP_EDGE_DTYPE / preprocess val_dtype).
# float32 is the exact baseline; float16/int8 trade bounded error for halved/
# quartered edge-value bytes on disk, in cache, AND over the HBM read the
# SpMV kernel performs (dequantization happens inside the kernel).
EDGE_VAL_DTYPES = ("float32", "float16", "int8")


# --------------------------------------------------------------------------
# edge-value quantization (per-shard affine scheme)
# --------------------------------------------------------------------------
def quantize_edge_vals(vals: np.ndarray, dtype: str) -> tuple[np.ndarray, float, float]:
    """Quantize a float32 edge-value array -> (q, scale, zero).

    Dequantization is the single affine formula used everywhere (kernel,
    jnp fallback, delta re-layout)::

        v_hat = (q.astype(float32) - zero) * scale

    * float32 — identity (scale=1, zero=0).
    * float16 — plain downcast (scale=1, zero=0); error <= 2^-11 * |v|.
    * int8    — affine over [vmin, vmax] widened to include 0, with the
      zero point rounded to an *integer* so v=0 (and therefore padded
      slots) quantizes to q=zero and dequantizes to exactly 0.0:
      scale=(vmax-vmin)/255, zero=rint(-128-vmin/scale),
      q=clip(rint(v/scale+zero)).  Max abs error stays scale/2: rounding
      the zero point shifts the whole grid by delta in [-1/2, 1/2] steps,
      and a range endpoint pushed past +-128 clips back by that same
      delta.  An all-zero array quantizes exactly (scale=1, zero=-128).

    scale/zero are rounded to float32 so every consumer (device kernels
    included) dequantizes with bit-identical parameters.
    """
    dt = np.dtype(dtype)
    if dt == np.float32:
        return vals.astype(np.float32), 1.0, 0.0
    if dt == np.float16:
        return vals.astype(np.float16), 1.0, 0.0
    if dt != np.int8:
        raise ValueError(f"unsupported edge-value dtype {dtype!r}; "
                         f"choose from {EDGE_VAL_DTYPES}")
    v = np.asarray(vals, dtype=np.float32)
    vmin = min(float(v.min(initial=0.0)), 0.0)
    vmax = max(float(v.max(initial=0.0)), 0.0)
    scale = (vmax - vmin) / 255.0
    if scale == 0.0:
        scale = 1.0
    scale = float(np.float32(scale))
    # Integer zero point: 0 lies in [vmin, vmax] by construction, so zero
    # lands in [-128, 127] and rint keeps it there — exact in float32.
    zero = float(np.float32(np.rint(-128.0 - vmin / scale)))
    q = np.clip(np.rint(v / np.float32(scale) + np.float32(zero)),
                -128, 127).astype(np.int8)
    return q, scale, zero


def dequantize_edge_vals(vals: np.ndarray, scale: float = 1.0,
                         zero: float = 0.0) -> np.ndarray:
    """Invert :func:`quantize_edge_vals` (float32 passes through untouched)."""
    if vals.dtype == np.float32:
        return vals
    return ((vals.astype(np.float32) - np.float32(zero))
            * np.float32(scale)).astype(np.float32)


# --------------------------------------------------------------------------
# Algorithm 1: compute vertex intervals
# --------------------------------------------------------------------------
def compute_intervals(in_degrees: np.ndarray, threshold_edge_num: int) -> np.ndarray:
    """Greedy interval cut, exactly Algorithm 1.

    Returns ``starts`` of shape [P+1]: shard p owns vertices
    [starts[p], starts[p+1]).  A single vertex whose in-degree exceeds the
    threshold gets its own interval (the paper requires the threshold to be
    no smaller than the max in-degree; we relax that by allowing singleton
    intervals, which the ELL row-wrapping then handles).
    """
    n = int(in_degrees.shape[0])
    if n == 0:
        return np.array([0], dtype=np.int64)
    csum = np.concatenate([[0], np.cumsum(in_degrees.astype(np.int64))])
    starts = [0]
    v = 0
    while v < n:
        # Largest end such that csum[end] - csum[v] <= threshold, end > v.
        end = int(np.searchsorted(csum, csum[v] + threshold_edge_num, side="right")) - 1
        end = max(end, v + 1)  # always make progress (singleton heavy vertex)
        end = min(end, n)
        starts.append(end)
        v = end
    return np.asarray(starts, dtype=np.int64)


# --------------------------------------------------------------------------
# CSR shard
# --------------------------------------------------------------------------
@dataclasses.dataclass
class CSRShard:
    """One destination-interval shard in CSR (paper's on-disk format)."""

    shard_id: int
    start_vertex: int  # first destination vertex id owned by this shard
    end_vertex: int    # one past the last destination vertex id
    row: np.ndarray    # [rows+1] int64 — CSR row pointers (rows = end-start)
    col: np.ndarray    # [nnz] int32/int64 — source vertex ids
    val: np.ndarray | None  # [nnz] float32 — edge weights (None ⇒ unweighted)

    @property
    def num_rows(self) -> int:
        return self.end_vertex - self.start_vertex

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def source_vertices(self) -> np.ndarray:
        return np.unique(self.col)


def build_csr_shards(
    src: np.ndarray,
    dst: np.ndarray,
    num_vertices: int,
    threshold_edge_num: int,
    val: np.ndarray | None = None,
) -> list[CSRShard]:
    """Preprocessing steps 2+3 (in memory): bucket edges by destination
    interval, sort/group by destination, emit CSR per shard."""
    in_deg = np.bincount(dst, minlength=num_vertices).astype(np.int64)
    starts = compute_intervals(in_deg, threshold_edge_num)
    order = np.argsort(dst, kind="stable")
    dst_sorted = dst[order]
    src_sorted = src[order]
    val_sorted = val[order] if val is not None else None
    # row pointer over *all* vertices, then slice per shard
    row_all = np.concatenate([[0], np.cumsum(in_deg)])
    shards = []
    for p in range(len(starts) - 1):
        lo, hi = int(starts[p]), int(starts[p + 1])
        e_lo, e_hi = int(row_all[lo]), int(row_all[hi])
        shards.append(
            CSRShard(
                shard_id=p,
                start_vertex=lo,
                end_vertex=hi,
                row=(row_all[lo : hi + 1] - row_all[lo]).astype(np.int64),
                col=src_sorted[e_lo:e_hi].astype(np.int32),
                val=None if val_sorted is None else val_sorted[e_lo:e_hi].astype(np.float32),
            )
        )
    return shards


# --------------------------------------------------------------------------
# Blocked-ELL shard (TPU layout)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ELLShard:
    """TPU-native shard: fixed-width padded rows, sentinel col = -1.

    ``row_map[r]`` gives the *local* destination row (0-based within the
    interval) that ELL row r accumulates into; heavy CSR rows occupy several
    consecutive ELL rows.  rows % SUBLANE == 0 and width % LANE == 0.
    """

    shard_id: int
    start_vertex: int
    end_vertex: int
    cols: np.ndarray     # [R, W] int32, sentinel -1
    vals: np.ndarray     # [R, W] float32 | float16 | int8 (see val_scale)
    row_map: np.ndarray  # [R] int32 — local destination row per ELL row
    nnz: int
    # Affine dequantization parameters for non-float32 ``vals`` (identity for
    # float32): true value = (vals.astype(f32) - val_zero) * val_scale.
    val_scale: float = 1.0
    val_zero: float = 0.0

    @property
    def shape(self) -> tuple[int, int]:
        return self.cols.shape  # (R, W)

    @property
    def quantized(self) -> bool:
        return self.vals.dtype != np.float32

    def vals_f32(self) -> np.ndarray:
        """Edge values dequantized to float32 (host-side consumers)."""
        return dequantize_edge_vals(self.vals, self.val_scale, self.val_zero)

    def padded_bytes(self) -> int:
        return self.cols.nbytes + self.vals.nbytes

    def decoded_nbytes(self) -> int:
        """Host bytes of the decoded shard (cols + vals + row_map) — the one
        definition shared by cache hot-tier accounting and pipeline
        staged-bytes accounting."""
        return self.padded_bytes() + self.row_map.nbytes

    def source_vertices(self) -> np.ndarray:
        c = self.cols[self.cols >= 0]
        return np.unique(c)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _bucket_pow2(x: int, floor: int) -> int:
    """Round up to a power of two (>= floor): shards share few distinct ELL
    shapes, so the jitted shard step compiles once per bucket, not per shard."""
    n = max(x, floor)
    return 1 << (n - 1).bit_length()


def _bucket_quarter_pow2(x: int, floor: int) -> int:
    """Round up to a quarter-power-of-two bucket (…, 1024, 1280, 1536, 1792,
    2048, …): ≤4 shapes per octave keeps jit compiles bounded while wasting
    ≤25% rows (vs ≤100% for pure pow2)."""
    n = max(x, floor)
    p = max(1 << max((n - 1).bit_length() - 2, 0), floor)
    return -(-n // p) * p


def csr_to_ell(shard: CSRShard, max_width: int = 512, lane: int = LANE) -> ELLShard:
    """Re-lay a CSR shard as blocked-ELL with row wrapping.

    ``max_width`` caps the ELL width (multiple of ``lane``); rows with degree
    above it wrap onto multiple ELL rows.  Width targets ~1.5× the mean
    degree — the row-wrapping absorbs the power-law tail, so sizing for the
    tail (e.g. p95) would only inflate padding.  ``lane`` is the hardware
    vector width the layout aligns to (128 on TPU; benches on CPU may pass
    a smaller value — the layout algebra is identical).
    """
    deg = np.diff(shard.row)
    if deg.size == 0 or deg.max() == 0:
        w = lane
    else:
        mean = float(deg[deg > 0].mean()) if (deg > 0).any() else 1.0
        w = min(_bucket_pow2(max(int(mean * 1.2), 1), lane),
                _round_up(max_width, lane))
    # number of ELL rows each CSR row expands into (>=1 so empty rows exist)
    reps = np.maximum(1, -(-deg // w)).astype(np.int64)
    r_used = int(reps.sum())
    R = _bucket_quarter_pow2(r_used, SUBLANE)
    # vectorized expansion: ELL row -> (csr row, occurrence within that row)
    row_map = np.zeros(R, dtype=np.int32)
    row_map[:r_used] = np.repeat(np.arange(shard.num_rows, dtype=np.int32), reps)
    ell_start = np.concatenate([[0], np.cumsum(reps)])  # first ELL row per CSR row
    cols = np.full((R, w), -1, dtype=np.int32)
    vals = np.zeros((R, w), dtype=np.float32)
    if shard.nnz:  # an interval can own zero edges: keep all-sentinel rows
        # scatter each edge to its slot (edge e, k-th of its CSR row:
        # ELL row ell_start[row] + k // w, slot k % w): work in nnz, not
        # in the padded R x w slots
        row_of = np.repeat(np.arange(shard.num_rows, dtype=np.int64), deg)
        k = np.arange(shard.nnz, dtype=np.int64) - shard.row[row_of]
        slot = (ell_start[row_of] + k // w) * w + k % w
        cols.reshape(-1)[slot] = shard.col
        vals.reshape(-1)[slot] = (1.0 if shard.val is None else shard.val)
    return ELLShard(
        shard_id=shard.shard_id,
        start_vertex=shard.start_vertex,
        end_vertex=shard.end_vertex,
        cols=cols,
        vals=vals,
        row_map=row_map,
        nnz=shard.nnz,
    )


def quantize_shard(shard: ELLShard, dtype: str) -> ELLShard:
    """Return ``shard`` with edge values stored as ``dtype`` (see
    :func:`quantize_edge_vals`).  float32 (or already-matching dtype) is a
    no-op returning the same object."""
    if np.dtype(dtype) == shard.vals.dtype:
        return shard
    if shard.quantized:  # re-quantizing: recover float32 first
        shard = dataclasses.replace(shard, vals=shard.vals_f32(),
                                    val_scale=1.0, val_zero=0.0)
    if np.dtype(dtype) == np.float32:
        return shard
    q, scale, zero = quantize_edge_vals(shard.vals, dtype)
    return dataclasses.replace(shard, vals=q, val_scale=scale, val_zero=zero)


def bucket_shards(shards: Sequence[ELLShard]) -> dict[tuple[int, int], list[ELLShard]]:
    """Group shards by (R, W) so each bucket jits once (VSW scan batches)."""
    buckets: dict[tuple[int, int], list[ELLShard]] = {}
    for s in shards:
        buckets.setdefault(s.shape, []).append(s)
    return buckets


def iter_edges(shard: CSRShard) -> Iterator[tuple[int, int, float]]:
    """Debug helper: yield (src, dst, val) triples of a CSR shard."""
    for local in range(shard.num_rows):
        lo, hi = int(shard.row[local]), int(shard.row[local + 1])
        for e in range(lo, hi):
            v = 1.0 if shard.val is None else float(shard.val[e])
            yield int(shard.col[e]), shard.start_vertex + local, v
