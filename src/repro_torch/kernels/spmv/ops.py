"""Public SpMV ops: pick the CUDA kernel or the plain torch version.

``use_kernel`` is a tri-state switch, decided by the tensors' device:

  * ``"auto"`` — CUDA tensors launch the hand-written kernel; CPU tensors
    take the plain version (``ref.py``).
  * ``True``   — launch the kernel; raises for CPU tensors.
  * ``False``  — the plain version on either device (the reference a
    kernel is held against on the card).

A CUDA tensor never reaches the plain version unless ``use_kernel=False``,
and a kernel that cannot be built or launched raises.

On CUDA, ``ell_spmv`` (one frontier column) and ``ell_spmv_batch`` (an
``[n, K]`` frontier) run the fused kernel, which gathers ``x[cols]`` inside
the kernel: that is the only production path, with no VMEM gate.
``fused=False`` gathers in torch and folds with the ``ell_fold`` /
``ell_fold_batch`` kernel; it exists so that tests and ``chip_smoke.py`` can
drive that kernel on the main path and hold it to the same results.  The
wrapped-row segment-combine runs after either kernel as torch ops.  Quantized edge
values (int8/float16 + ``(scale, zero)`` qparams) are dequantized inside the
kernels and by ``ref.maybe_dequantize`` on the plain path, with the same
rounding.

``ell_gather_fold`` folds one 2-D tile of ``core.distributed.spmv_2d``:
its cols are local to a source block ``x_blk``, from which the kernel
gathers.  Given the tile's ``ell_row_extents`` it reads each row only up to
its last valid slot.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spmv import cuda as _cuda
from repro_torch.kernels.spmv import ref as _ref
from repro_torch.kernels.spmv.ref import ell_row_extents  # noqa: F401

USE_KERNEL_CHOICES = (True, False, "auto")


def uses_kernel(use_kernel, device: torch.device | str) -> bool:
    """Whether a call on tensors on ``device`` launches a CUDA kernel."""
    if use_kernel not in USE_KERNEL_CHOICES:
        raise ValueError(f"use_kernel must be True, False or 'auto', "
                         f"got {use_kernel!r}")
    if use_kernel is False:
        return False
    if torch.device(device).type == "cuda":
        return True
    if use_kernel is True:
        raise ValueError(f"use_kernel=True needs CUDA tensors; these lie on "
                         f"{device} (pass use_kernel='auto' or False)")
    return False


def describe_dispatch(use_kernel="auto", *, device: torch.device | str,
                      k: int = 1, fused: bool = True) -> str:
    """Path ``ell_spmv`` (``k == 1``) or ``ell_spmv_batch`` (``k`` frontier
    columns) takes for tensors on ``device``: ``torch`` | ``cuda:fused``
    (production) | ``cuda:gather+fold`` (only with ``fused=False``, the test
    switch that drives the fold kernel).  Unlike the reference's VMEM gate,
    ``k`` picks no path here: the kernels take any K."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not uses_kernel(use_kernel, device):
        return "torch"
    return "cuda:fused" if fused else "cuda:gather+fold"


def ell_fold(xg, vals, cols, semiring, use_kernel="auto", qparams=None):
    """[R, W] pre-gathered sources + edges -> [R, 1] partials."""
    if uses_kernel(use_kernel, xg.device):
        return _cuda.ell_fold(xg, vals, cols, semiring, qparams)
    return _ref.ell_fold_ref(xg, _ref.maybe_dequantize(vals, qparams), cols,
                             semiring)


def ell_gather_fold(x_blk, cols, vals, semiring, use_kernel="auto",
                    qparams=None, extents=None):
    """[VB] source block + [R, W] tile with local cols -> [R, 1].

    ``extents`` is the tile's ``ell_row_extents(cols)`` (int32 [R], on the
    tile's device, built once with the tile): the fold then reads each row
    only up to its last valid slot.  ``None`` walks every slot."""
    if extents is not None:
        check_extents(extents, cols)
    if uses_kernel(use_kernel, x_blk.device):
        return _cuda.ell_gather_fold(x_blk, cols, vals, semiring, qparams,
                                     extents)
    return _ref.ell_gather_fold_ref(x_blk, cols,
                                    _ref.maybe_dequantize(vals, qparams),
                                    semiring, extents)


def check_extents(extents, cols) -> None:
    """Raise unless ``extents`` are int32 row extents of the ``[..., R, W]``
    ``cols`` on the same device."""
    if extents.device != cols.device:
        raise ValueError(f"extents lie on {extents.device}, the tile on "
                         f"{cols.device}")
    if extents.dtype != torch.int32 or extents.shape != cols.shape[:-1]:
        raise ValueError(f"extents must be int32 of shape "
                         f"{tuple(cols.shape[:-1])}, got {extents.dtype} "
                         f"{tuple(extents.shape)}")


def ell_spmv(x, cols, vals, row_map, num_segments: int, semiring,
             use_kernel="auto", qparams=None, fused: bool = True):
    """Full shard update: gather + fold + segment combine.

    x: [n] resident source array; returns [num_segments] partials for the
    shard's destination interval (identity where the interval has no edges).
    """
    if not uses_kernel(use_kernel, x.device):
        return _ref.ell_spmv_ref(x, cols, _ref.maybe_dequantize(vals, qparams),
                                 row_map, num_segments, semiring)
    if fused:
        partials = _cuda.ell_spmv_fused(x, cols, vals, semiring, qparams)
    else:
        partials = _cuda.ell_fold(_ref.gather(x, cols), vals, cols, semiring,
                                  qparams)
    return _ref.segment_combine(partials, row_map, num_segments, semiring)


def ell_spmv_batch(x, cols, vals, row_map, num_segments: int, semiring,
                   use_kernel="auto", qparams=None, fused: bool = True):
    """Batched shard update: one edge pass serves K frontiers.

    x: [n, K] resident source matrix; returns [num_segments, K] partials —
    column k is exactly ``ell_spmv(x[:, k], ...)``.  The fused kernel never
    materializes the [R, W, K] gathered matrix; ``fused=False`` gathers it
    in torch and folds it with the ``ell_fold_batch`` kernel.
    """
    if not uses_kernel(use_kernel, x.device):
        return _ref.ell_spmv_batch_ref(x, cols,
                                       _ref.maybe_dequantize(vals, qparams),
                                       row_map, num_segments, semiring)
    if fused:
        partials = _cuda.ell_spmv_fused_batch(x, cols, vals, semiring,
                                              qparams)
    else:
        partials = _cuda.ell_fold_batch(_ref.gather(x, cols), vals, cols,
                                        semiring, qparams)
    return _ref.segment_combine_batch(partials, row_map, num_segments,
                                      semiring)
