"""Public SpMV ops: pick the CUDA kernel or the plain torch version.

``use_kernel`` is a tri-state switch, decided by the tensors' device:

  * ``"auto"`` — CUDA tensors launch the hand-written kernel; CPU tensors
    take the plain version (``ref.py``).
  * ``True``   — launch the kernel; raises for CPU tensors.
  * ``False``  — the plain version on either device (the reference a
    kernel is held against on the card).

A CUDA tensor never reaches the plain version unless ``use_kernel=False``,
and a kernel that cannot be built or launched raises.

On CUDA, ``ell_spmv`` (one frontier column) runs the fused kernel, which
gathers ``x[cols]`` inside the kernel: that is the only production path,
with no VMEM gate.  ``fused=False`` gathers in torch and folds with the
``ell_fold`` kernel; it exists so that tests and ``chip_smoke.py`` can drive
that kernel on the main path and hold it to the same results.  The wrapped-
row segment-combine runs after either kernel as torch ops.  Quantized edge
values (int8/float16 + ``(scale, zero)`` qparams) are dequantized inside the
kernels and by ``ref.maybe_dequantize`` on the plain path, with the same
rounding.

``ell_gather_fold`` (the reference's 2-D-tiled ``ell_gather_fold_pallas``,
used only by its multi-device engine) has no kernel yet (ROADMAP B4): it
runs the plain version where the switch allows one and raises where it asks
for the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.spmv import cuda as _cuda
from repro_torch.kernels.spmv import ref as _ref

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
                      fused: bool = True) -> str:
    """Path ``ell_spmv`` takes for tensors on ``device``:
    ``torch`` | ``cuda:fused`` (production) | ``cuda:gather+fold`` (only
    with ``fused=False``, the test switch that drives the fold kernel)."""
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
                    qparams=None):
    """Local-block gather + fold -> [R, 1]; plain version only (see above)."""
    if uses_kernel(use_kernel, x_blk.device):
        raise NotImplementedError(
            "ell_gather_fold has no CUDA kernel yet (ROADMAP B4); pass "
            "use_kernel=False for the plain version")
    return _ref.ell_gather_fold_ref(x_blk, cols,
                                    _ref.maybe_dequantize(vals, qparams),
                                    semiring)


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
