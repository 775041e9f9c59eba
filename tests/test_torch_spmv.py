"""The port's SpMV ops (plain torch versions, on the CPU) held against the
reference package's ops on the same numpy inputs.

The reference side runs its Pallas kernels with ``use_pallas=True``, which
is interpret mode on the CPU.  Tolerances:

* min/max semirings: bitwise.  A min or max of the same float32 values is
  exact whatever the order, and both sides dequantize op by op.
* quantized min_plus: at most 1 ulp, because XLA may contract the
  dequantize multiply with min_plus's add into one FMA (``ref.py:38-41`` of
  the reference).
* plus semirings: ``rtol=PLUS_RTOL``.  Each output sums at most 2·W = 512
  positive float32 terms (a row plus its wrapped rows) in another order;
  the worst case relative difference is about 512·2^-24 ≈ 3.1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spmv import ops as jops
from repro.kernels.spmv import ref as jref
from repro_torch.core.semiring import SEMIRINGS
from repro_torch.core.shards import CSRShard, csr_to_ell, quantize_shard
from repro_torch.kernels.spmv import cuda, ops, ref

SEMIS = list(SEMIRINGS)
DTYPES = ["float32", "float16", "int8"]
PLUS_RTOL = 3.1e-5
N_SRC = 1000


def _shard(seed: int, max_width: int, dtype: str):
    """A blocked-ELL shard with wrapped rows (3 rows above max_width),
    rows with no in-edges, padding rows at row_map = 0, and -1 sentinels;
    quantized through the vendored quantizer when dtype is not float32."""
    rng = np.random.default_rng(seed)
    num_rows = 40
    deg = rng.integers(0, 2 * max_width // 3, size=num_rows)
    deg[[3, 17, 30]] = [max_width + 5, 2 * max_width + 1, 3 * max_width]
    deg[[5, 6, 22]] = 0
    row = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nnz = int(row[-1])
    csr = CSRShard(shard_id=0, start_vertex=0, end_vertex=num_rows, row=row,
                   col=rng.integers(0, N_SRC, size=nnz).astype(np.int32),
                   val=(rng.random(nnz) * 9 + 0.5).astype(np.float32))
    ell = quantize_shard(csr_to_ell(csr, max_width=max_width), dtype)
    assert ell.shape[0] > int(ell.row_map.max()) + 1  # padding + empty segments
    return ell


def _frontier(seed: int, semiring: str) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    x = (rng.random(N_SRC) * 100).astype(np.float32)
    if not SEMIRINGS[semiring].is_plus:
        x[rng.random(N_SRC) < 0.2] = np.inf  # unreached vertices
    return x


def _qp(ell):
    return (ell.val_scale, ell.val_zero)


def _assert_matches(got: np.ndarray, want: np.ndarray, semiring: str,
                    dtype: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype
    if SEMIRINGS[semiring].is_plus:
        np.testing.assert_allclose(got, want, rtol=PLUS_RTOL, atol=0)
    elif semiring == "min_plus" and dtype != "float32":
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_array_max_ulp(got[fin], want[fin], maxulp=1)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("semiring", SEMIS)
@pytest.mark.parametrize("max_width", [128, 256])
def test_ell_spmv_matches_reference(max_width, semiring, dtype):
    ell = _shard(max_width, max_width, dtype)
    x = _frontier(max_width, semiring)
    R = ell.shape[0]
    want = jops.ell_spmv(jnp.asarray(x), jnp.asarray(ell.cols),
                         jnp.asarray(ell.vals), jnp.asarray(ell.row_map), R,
                         semiring, use_pallas=True,
                         qparams=jnp.asarray(_qp(ell), jnp.float32))
    got = ops.ell_spmv(torch.from_numpy(x), torch.from_numpy(ell.cols),
                       torch.from_numpy(ell.vals),
                       torch.from_numpy(ell.row_map), R, semiring,
                       qparams=_qp(ell))
    _assert_matches(got.numpy(), np.asarray(want), semiring, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("semiring", SEMIS)
def test_ell_fold_matches_reference(semiring, dtype):
    ell = _shard(7, 256, dtype)
    x = _frontier(7, semiring)
    xg = x[np.where(ell.cols >= 0, ell.cols, 0)]
    want = jops.ell_fold(jnp.asarray(xg), jnp.asarray(ell.vals),
                         jnp.asarray(ell.cols), semiring, use_pallas=True,
                         qparams=jnp.asarray(_qp(ell), jnp.float32))
    got = ops.ell_fold(torch.from_numpy(xg), torch.from_numpy(ell.vals),
                       torch.from_numpy(ell.cols), semiring, qparams=_qp(ell))
    assert got.shape == (ell.shape[0], 1)
    _assert_matches(got.numpy(), np.asarray(want), semiring, dtype)


@pytest.mark.parametrize("semiring", SEMIS)
def test_ell_gather_fold_matches_reference(semiring):
    ell = _shard(11, 128, "int8")
    x = _frontier(11, semiring)
    want = jops.ell_gather_fold(jnp.asarray(x), jnp.asarray(ell.cols),
                                jnp.asarray(ell.vals), semiring,
                                use_pallas=True,
                                qparams=jnp.asarray(_qp(ell), jnp.float32))
    got = ops.ell_gather_fold(torch.from_numpy(x), torch.from_numpy(ell.cols),
                              torch.from_numpy(ell.vals), semiring,
                              qparams=_qp(ell))
    _assert_matches(got.numpy(), np.asarray(want), semiring, "int8")


@pytest.mark.parametrize("semiring", SEMIS)
def test_segment_combine_matches_reference(semiring):
    """Unsorted row_map (padding rows point at 0) and empty segments, which
    must hold the identity."""
    rng = np.random.default_rng(5)
    R, num_segments = 64, 80
    partials = (rng.random((R, 1)) * 10).astype(np.float32)
    row_map = rng.integers(0, 40, size=R).astype(np.int32)
    row_map[-8:] = 0
    want = jref.segment_combine(jnp.asarray(partials), jnp.asarray(row_map),
                                num_segments, semiring)
    got = ref.segment_combine(torch.from_numpy(partials),
                              torch.from_numpy(row_map), num_segments,
                              semiring)
    _assert_matches(got.numpy(), np.asarray(want), semiring, "float32")
    empty = np.setdiff1d(np.arange(num_segments), row_map)
    assert (got.numpy()[empty] == SEMIRINGS[semiring].identity).all()


@pytest.mark.parametrize("dtype", ["float16", "int8"])
def test_maybe_dequantize_bitwise(dtype):
    ell = _shard(3, 128, dtype)
    want = jref.maybe_dequantize(jnp.asarray(ell.vals),
                                 jnp.asarray(_qp(ell), jnp.float32))
    got = ref.maybe_dequantize(torch.from_numpy(ell.vals), _qp(ell))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), ell.vals_f32())


@pytest.mark.parametrize("semiring", SEMIS)
def test_all_masked_rows_give_identity(semiring):
    cols = torch.full((8, 128), -1, dtype=torch.int32)
    out = ops.ell_spmv(torch.ones(16), cols, torch.zeros(8, 128),
                       torch.zeros(8, dtype=torch.int32), 8, semiring)
    assert out.tolist() == [SEMIRINGS[semiring].identity] * 8


def test_dispatch_on_cpu():
    assert ops.describe_dispatch("auto", device="cpu") == "torch"
    assert ops.describe_dispatch(False, device="cuda") == "torch"
    assert ops.describe_dispatch("auto", device="cuda") == "cuda:fused"
    assert ops.describe_dispatch(True, device="cuda",
                                 fused=False) == "cuda:gather+fold"
    with pytest.raises(ValueError, match="use_kernel"):
        ops.describe_dispatch("yes", device="cpu")
    ell = _shard(1, 128, "float32")
    args = (torch.from_numpy(ell.cols), torch.from_numpy(ell.vals))
    before = dict(cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ell_spmv(torch.ones(N_SRC), *args, torch.from_numpy(ell.row_map),
                     ell.shape[0], "min_plus", use_kernel=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ell_fold(torch.ones(ell.shape), args[1], args[0], "min_plus",
                     use_kernel=True)
    # the kernel wrappers refuse CPU tensors before building anything
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda.ell_spmv_fused(torch.ones(N_SRC), *args, "min_plus")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ell_gather_fold(torch.ones(N_SRC), *args, "min_plus",
                            use_kernel=True)
    assert cuda.launches == before
