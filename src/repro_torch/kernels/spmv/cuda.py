"""The hand-written CUDA kernels of the blocked-ELL SpMV, bound with ctypes.

``csrc/ell_spmv.cu`` holds both kernels behind a plain C interface.  The
first call builds it with ``nvcc`` for ``sm_90a`` into ``_build/`` beside
this file (named by a hash of the source and flags, so an edited source
rebuilds) and loads it with ``ctypes``; importing this module builds nothing.

Kernels and the Pallas TPU kernels they replace
(``src/repro/kernels/spmv/spmv.py``):

  * ``ell_spmv_fused``       — ``ell_spmv_fused_pallas`` with K = 1: gathers
    the frontier ``x[cols]`` inside the kernel, folds each ELL row -> [R, 1].
  * ``ell_fold``             — ``ell_fold_pallas``: folds pre-gathered
    sources ``xg [R, W]`` -> [R, 1].
  * ``ell_spmv_fused_batch`` — ``ell_spmv_fused_pallas`` with K > 1: the
    same with an ``[n, K]`` frontier -> [R, K].
  * ``ell_fold_batch``       — ``ell_fold_batch_pallas``: folds
    ``xg [R, W, K]`` -> [R, K].
  * ``ell_gather_fold``      — ``ell_gather_fold_pallas``: a 2-D tile whose
    cols index one source block ``x_blk [VB]`` -> [R, 1], gathered
    through L2, each row read up to its extent when the tile's
    ``ell_row_extents`` are given.

The batched wrappers hand K = 1 to the single-column kernels (and count it
under their names).  Each wrapper checks device, dtype, shape, contiguity
and alignment, allocates its output with ``torch.empty``, launches on the
current stream, raises if the launch was refused, and adds one to
``launches[<name>]`` (under a lock: service threads launch concurrently).
It takes CUDA tensors only: the plain versions live in ``ref.py`` and
``ops.py`` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.core.semiring import SEMIRING_IDS, SEMIRINGS, Semiring

SOURCE = Path(__file__).parent / "csrc" / "ell_spmv.cu"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# value dtype ids shared with csrc/ell_spmv.cu (enum Dt)
_DTYPE_IDS = {torch.float32: 0, torch.float16: 1, torch.int8: 2}
# ELL widths are multiples of this (the stored format's LANE padding); the
# kernels walk a row 128 slots per warp step
_WIDTH_MULTIPLE = 128

# launch counts, one per kernel: a wrapper adds one each time it launches
launches = {"ell_spmv_fused": 0, "ell_fold": 0, "ell_spmv_fused_batch": 0,
            "ell_fold_batch": 0, "ell_gather_fold": 0}
_launches_lock = threading.Lock()

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    with _launches_lock:
        for name in launches:
            launches[name] = 0


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the SpMV kernels are built from "
                           f"{SOURCE.name} at first use")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libell_spmv_{digest[:16]}.so"


def build() -> Path:
    """Compile ``csrc/ell_spmv.cu`` unless this source's library exists."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic publish: a concurrent loader never sees half
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn in (lib.ell_spmv_fused, lib.ell_fold):
                # (src, cols, vals, out, rows, width, k, semiring, dtype,
                #  scale, zero, stream)
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_float,
                               ctypes.c_float, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            # (x_blk, cols, vals, extents, out, rows, width, semiring,
            #  dtype, scale, zero, stream)
            lib.ell_gather_fold.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_void_p]
            lib.ell_gather_fold.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, device: torch.device, dtypes,
           ndim: int, align: int = 16) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must have dtype in {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte "
                         "aligned")


def _edges(cols: torch.Tensor, vals: torch.Tensor, device: torch.device,
           semiring: Semiring | str, qparams) -> tuple:
    """Check an [R, W] tile's cols/vals -> ``(rows, width, semiring id,
    dtype id, scale, zero)``."""
    _check("cols", cols, device, (torch.int32,), 2)
    _check("vals", vals, device, tuple(_DTYPE_IDS), 2)
    if vals.shape != cols.shape:
        raise ValueError(f"vals {tuple(vals.shape)} and cols "
                         f"{tuple(cols.shape)} differ in shape")
    rows, width = cols.shape
    if width % _WIDTH_MULTIPLE:
        raise ValueError(f"ELL width must be a multiple of "
                         f"{_WIDTH_MULTIPLE}, got {width}")
    sem = semiring if isinstance(semiring, str) else semiring.name
    if sem not in SEMIRINGS:
        raise KeyError(f"unknown semiring {sem!r}")
    scale, zero = (1.0, 0.0) if qparams is None else map(float, qparams)
    return rows, width, SEMIRING_IDS[sem], _DTYPE_IDS[vals.dtype], scale, zero


def _counted(counter: str, rc: int, what: str) -> None:
    """Raise if the launch was refused, else count it."""
    if rc != 0:
        raise RuntimeError(f"{counter} launch failed with CUDA error {rc} "
                           f"({what})")
    with _launches_lock:
        launches[counter] += 1


def _launch(kernel: str, src: torch.Tensor, cols: torch.Tensor,
            vals: torch.Tensor, semiring: Semiring | str, qparams,
            k: int) -> torch.Tensor:
    """Launch ``kernel`` (the C entry point) for ``k`` columns -> [R, k];
    counted under ``kernel`` for k = 1 and ``<kernel>_batch`` above."""
    device = src.device
    rows, width, *args = _edges(cols, vals, device, semiring, qparams)
    out = torch.empty((rows, k), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, kernel)(
            src.data_ptr(), cols.data_ptr(), vals.data_ptr(), out.data_ptr(),
            rows, width, k, *args, stream)
    _counted(kernel if k == 1 else f"{kernel}_batch", rc,
             f"rows={rows}, width={width}, k={k}, semiring={semiring}, "
             f"vals={vals.dtype}")
    return out


def ell_spmv_fused(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                   semiring: Semiring | str, qparams=None) -> torch.Tensor:
    """[n] frontier + [R, W] blocked-ELL -> [R, 1] per-ELL-row partials,
    gathering ``x[cols]`` inside the kernel.  ``qparams`` is the
    ``(scale, zero)`` pair of int8/float16 ``vals``."""
    _check("x", x, x.device, (torch.float32,), 1)
    return _launch("ell_spmv_fused", x, cols, vals, semiring, qparams, 1)


def ell_fold(xg: torch.Tensor, vals: torch.Tensor, cols: torch.Tensor,
             semiring: Semiring | str, qparams=None) -> torch.Tensor:
    """[R, W] pre-gathered sources + [R, W] edges -> [R, 1] partials."""
    _check("xg", xg, xg.device, (torch.float32,), 2)
    if xg.shape != cols.shape:
        raise ValueError(f"xg {tuple(xg.shape)} and cols {tuple(cols.shape)} "
                         "differ in shape")
    return _launch("ell_fold", xg, cols, vals, semiring, qparams, 1)


def ell_spmv_fused_batch(x: torch.Tensor, cols: torch.Tensor,
                         vals: torch.Tensor, semiring: Semiring | str,
                         qparams=None) -> torch.Tensor:
    """[n, K] frontier + [R, W] blocked-ELL -> [R, K] partials, gathering
    ``x[cols, :]`` inside the kernel (float4 loads when K % 4 == 0 and
    ``x`` is 16-byte aligned, else one float a lane)."""
    _check("x", x, x.device, (torch.float32,), 2, align=4)
    return _launch("ell_spmv_fused", x, cols, vals, semiring, qparams,
                   x.shape[1])


def ell_fold_batch(xg: torch.Tensor, vals: torch.Tensor, cols: torch.Tensor,
                   semiring: Semiring | str, qparams=None) -> torch.Tensor:
    """[R, W, K] pre-gathered sources + shared [R, W] edges -> [R, K]."""
    _check("xg", xg, xg.device, (torch.float32,), 3, align=4)
    if xg.shape[:2] != cols.shape:
        raise ValueError(f"xg {tuple(xg.shape)} and cols {tuple(cols.shape)} "
                         "differ in their first two dims")
    return _launch("ell_fold", xg, cols, vals, semiring, qparams,
                   xg.shape[2])


def ell_gather_fold(x_blk: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor, semiring: Semiring | str,
                    qparams=None,
                    extents: torch.Tensor | None = None) -> torch.Tensor:
    """[VB] source block + [R, W] blocked-ELL tile whose cols are local to
    the block (``-1`` or in ``[0, VB)``, which the kernel does not check)
    -> [R, 1] per-ELL-row partials.  ``extents`` (int32 [R],
    ``ref.ell_row_extents(cols)``) bound each row's walk; ``None`` walks
    all W slots."""
    device = x_blk.device
    # the kernel reads x_blk one float at a time, so a block sliced out of
    # a frontier at any vertex will do: no 16-byte alignment asked
    if (device.type != "cuda" or x_blk.dtype != torch.float32
            or x_blk.dim() != 1 or not x_blk.is_contiguous()):
        raise ValueError(f"x_blk must be a contiguous 1-D float32 CUDA "
                         f"tensor, got {x_blk.dtype} {tuple(x_blk.shape)} "
                         f"on {device}")
    rows, width, *args = _edges(cols, vals, device, semiring, qparams)
    if extents is not None:
        # read one int a row: float alignment will do
        _check("extents", extents, device, (torch.int32,), 1, align=4)
        if extents.shape[0] != rows:
            raise ValueError(f"extents have {extents.shape[0]} rows, the "
                             f"tile {rows}")
    out = torch.empty((rows, 1), dtype=torch.float32, device=device)
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.ell_gather_fold(
            x_blk.data_ptr(), cols.data_ptr(), vals.data_ptr(),
            None if extents is None else extents.data_ptr(), out.data_ptr(),
            rows, width, *args, stream)
    _counted("ell_gather_fold", rc,
             f"rows={rows}, width={width}, vb={x_blk.shape[0]}, "
             f"extents={extents is not None}, semiring={semiring}, "
             f"vals={vals.dtype}")
    return out
