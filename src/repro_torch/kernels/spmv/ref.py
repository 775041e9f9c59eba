"""Plain torch versions of the blocked-ELL semiring SpMV kernels.

These are what the CUDA kernels (``cuda.py``) are held against on the card,
and what ``ops.py`` runs for tensors that lie on the CPU.  Each op runs one
torch operation at a time, so nothing is contracted into an FMA: the kernels
round with explicit ``__fsub_rn``/``__fmul_rn``/``__fadd_rn`` to match.
"""
from __future__ import annotations

import torch

from repro_torch.core.semiring import SEMIRINGS, Semiring

# Edge-value storage dtypes that carry affine qparams (see
# repro_torch.core.shards.quantize_edge_vals).
QUANTIZED_DTYPES = (torch.int8, torch.float16)


def _as_semiring(s: Semiring | str) -> Semiring:
    return SEMIRINGS[s] if isinstance(s, str) else s


def maybe_dequantize(vals: torch.Tensor, qparams=None) -> torch.Tensor:
    """Dequantize int8/float16 edge values to float32 with the canonical
    affine formula ``(q - zero) * scale``; other dtypes pass through.

    ``qparams`` is ``(scale, zero)`` (two floats, already float32-exact, as
    ``quantize_edge_vals`` stores them) or ``None`` for identity parameters.
    """
    if vals.dtype not in QUANTIZED_DTYPES:
        return vals
    v = vals.to(torch.float32)
    if qparams is None:
        return v
    scale, zero = (float(q) for q in qparams)
    return (v - zero) * scale


def gather(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """x[cols] with sentinel (-1) slots clamped to 0: [n] -> cols' shape,
    [n, K] -> cols' shape + [K]."""
    safe = torch.where(cols >= 0, cols, 0)
    return torch.index_select(x, 0, safe.reshape(-1)).reshape(
        cols.shape + x.shape[1:])


def ell_fold_ref(xg: torch.Tensor, vals: torch.Tensor, cols: torch.Tensor,
                 semiring: Semiring | str) -> torch.Tensor:
    """[R, W] gathered sources + edge vals -> [R, 1] per-ELL-row partials.

    ``cols < 0`` marks padded slots (contribute the reduce identity).
    """
    sem = _as_semiring(semiring)
    return sem.fold(vals, xg, cols >= 0, dim=-1)[:, None]


def ell_fold_batch_ref(xg: torch.Tensor, vals: torch.Tensor,
                       cols: torch.Tensor,
                       semiring: Semiring | str) -> torch.Tensor:
    """Batched fold: [R, W, K] gathered sources + shared [R, W] edges ->
    [R, K].  ``cols < 0`` slots contribute the identity in every column."""
    return _as_semiring(semiring).fold_batch(vals, xg, cols >= 0)


def ell_row_extents(cols: torch.Tensor) -> torch.Tensor:
    """``[..., W]`` cols -> int32 ``[...]`` row extents: ``1 +`` the last
    slot of the row with ``cols >= 0``, 0 for an all-padding row.

    Slots at ``w >= ext`` are padding by definition, so a fold may skip them
    on any input, prefix-packed or not.  They belong to a tile's layout:
    build them once, where the tile is laid out, not per call."""
    w = torch.arange(1, cols.shape[-1] + 1, dtype=torch.int32,
                     device=cols.device)
    return torch.where(cols >= 0, w, 0).amax(dim=-1).to(torch.int32)


def ell_gather_fold_ref(x_blk: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor, semiring: Semiring | str,
                        extents: torch.Tensor | None = None) -> torch.Tensor:
    """2-D-tiled variant: cols index a small *local* source block x_blk [VB].
    With ``extents`` ([R], ``ell_row_extents``), slots at ``w >= ext[r]``
    count as padding."""
    if extents is not None:
        w = torch.arange(cols.shape[1], device=cols.device)
        cols = torch.where(w < extents[:, None], cols, -1)
    return ell_fold_ref(gather(x_blk, cols), vals, cols, semiring)


def segment_combine(partials: torch.Tensor, row_map: torch.Tensor,
                    num_segments: int,
                    semiring: Semiring | str) -> torch.Tensor:
    """Fold wrapped ELL rows of the same destination: [R] -> [num_segments].

    The output starts filled with the semiring identity, so an empty segment
    holds the identity (as ``jax.ops.segment_*`` leaves it).  ``row_map`` is
    not assumed sorted: padding rows sit at destination 0 and contribute the
    identity there.
    """
    return segment_combine_batch(partials.reshape(-1), row_map, num_segments,
                                 semiring)


def segment_combine_batch(partials: torch.Tensor, row_map: torch.Tensor,
                          num_segments: int,
                          semiring: Semiring | str) -> torch.Tensor:
    """Batched wrapped-row fold: [R, K] -> [num_segments, K] (and [R] ->
    [num_segments]); segment ids index the leading axis, so every column
    folds in one scatter, under the same rules as ``segment_combine``."""
    sem = _as_semiring(semiring)
    out = torch.full((num_segments,) + partials.shape[1:], sem.identity,
                     dtype=partials.dtype, device=partials.device)
    idx = row_map.to(torch.int64)
    if sem.is_plus:
        return out.index_add_(0, idx, partials)
    if partials.dim() == 2:
        idx = idx[:, None].expand(partials.shape)
    return out.scatter_reduce_(0, idx, partials,
                               "amax" if sem.is_max else "amin",
                               include_self=True)


def ell_spmv_ref(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                 row_map: torch.Tensor, num_segments: int,
                 semiring: Semiring | str) -> torch.Tensor:
    """Full shard update: gather + fold + segment-combine.

    x: [n] resident source values; cols/vals: [R, W] blocked-ELL;
    row_map: [R] local destination row per ELL row; -> [num_segments].
    """
    partials = ell_fold_ref(gather(x, cols), vals, cols, semiring)
    return segment_combine(partials, row_map, num_segments, semiring)


def ell_spmv_batch_ref(x: torch.Tensor, cols: torch.Tensor,
                       vals: torch.Tensor, row_map: torch.Tensor,
                       num_segments: int,
                       semiring: Semiring | str) -> torch.Tensor:
    """Batched shard update: x is [n, K] -> [num_segments, K]; column k is
    ``ell_spmv_ref(x[:, k], ...)``."""
    partials = ell_fold_batch_ref(gather(x, cols), vals, cols, semiring)
    return segment_combine_batch(partials, row_map, num_segments, semiring)
