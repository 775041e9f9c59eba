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
    """x[cols] with sentinel (-1) slots clamped to 0 -> same shape as cols."""
    safe = torch.where(cols >= 0, cols, 0)
    return torch.index_select(x, 0, safe.reshape(-1)).reshape(cols.shape)


def ell_fold_ref(xg: torch.Tensor, vals: torch.Tensor, cols: torch.Tensor,
                 semiring: Semiring | str) -> torch.Tensor:
    """[R, W] gathered sources + edge vals -> [R, 1] per-ELL-row partials.

    ``cols < 0`` marks padded slots (contribute the reduce identity).
    """
    sem = _as_semiring(semiring)
    return sem.fold(vals, xg, cols >= 0, dim=-1)[:, None]


def ell_gather_fold_ref(x_blk: torch.Tensor, cols: torch.Tensor,
                        vals: torch.Tensor,
                        semiring: Semiring | str) -> torch.Tensor:
    """2-D-tiled variant: cols index a small *local* source block x_blk [VB]."""
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
    sem = _as_semiring(semiring)
    p = partials.reshape(-1)
    out = torch.full((num_segments,), sem.identity, dtype=p.dtype,
                     device=p.device)
    idx = row_map.to(torch.int64)
    if sem.is_plus:
        return out.index_add_(0, idx, p)
    return out.scatter_reduce_(0, idx, p, "amax" if sem.is_max else "amin",
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
