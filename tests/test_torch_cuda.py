"""The CUDA kernels on the card, held against their plain torch versions on
the same card.  Marked ``cuda``: they skip without a GPU.  This file imports
no jax (the machine with the card has none).  Run it there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: min/max semirings bitwise (the kernels round op by op like the
plain version); plus semirings ``rtol=PLUS_RTOL`` (a row of W <= 512
positive float32 terms summed in another order: at most 512·2^-24).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.semiring import SEMIRINGS
from repro_torch.core.shards import CSRShard, csr_to_ell, quantize_shard
from repro_torch.graph.generate import materialize, rmat_edges
from repro_torch.graph.preprocess import preprocess_graph
from repro_torch.graph.storage import write_edge_list
from repro_torch.kernels.spmv import cuda, ops, ref
from repro_torch.session import GraphSession

pytestmark = pytest.mark.cuda

SEMIS = list(SEMIRINGS)
PLUS_RTOL = 3.1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _shard(seed, dtype, num_rows=3000, n_src=50_000, max_width=256):
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.8, size=num_rows), 4 * max_width)
    deg[rng.random(num_rows) < 0.1] = 0
    row = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    nnz = int(row[-1])
    csr = CSRShard(shard_id=0, start_vertex=0, end_vertex=num_rows, row=row,
                   col=rng.integers(0, n_src, size=nnz).astype(np.int32),
                   val=(rng.random(nnz) * 9 + 0.5).astype(np.float32))
    return quantize_shard(csr_to_ell(csr, max_width=max_width), dtype)


def _assert_close(got, want, semiring):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if SEMIRINGS[semiring].is_plus:
        np.testing.assert_allclose(got, want, rtol=PLUS_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8"])
@pytest.mark.parametrize("semiring", SEMIS)
def test_kernels_match_plain(dev, semiring, dtype):
    ell = _shard(len(semiring), dtype)
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.random(50_000) * 100).astype(np.float32)).to(dev)
    if not SEMIRINGS[semiring].is_plus:
        x[torch.from_numpy(rng.random(50_000) < 0.2).to(dev)] = float("inf")
    cols = torch.from_numpy(ell.cols).to(dev)
    vals = torch.from_numpy(ell.vals).to(dev)
    qp = (ell.val_scale, ell.val_zero)
    deq = ref.maybe_dequantize(vals, qp)
    before = dict(cuda.launches)
    got = cuda.ell_spmv_fused(x, cols, vals, semiring, qp)
    _assert_close(got, ref.ell_fold_ref(ref.gather(x, cols), deq, cols,
                                        semiring), semiring)
    xg = ref.gather(x, cols)
    got = cuda.ell_fold(xg, vals, cols, semiring, qp)
    torch.cuda.synchronize()
    _assert_close(got, ref.ell_fold_ref(xg, deq, cols, semiring), semiring)
    assert cuda.launches["ell_spmv_fused"] == before["ell_spmv_fused"] + 1
    assert cuda.launches["ell_fold"] == before["ell_fold"] + 1


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    ell = _shard(0, "float32")
    x = torch.ones(50_000, device=dev)
    cols = torch.from_numpy(ell.cols).to(dev)
    vals = torch.from_numpy(ell.vals).to(dev)
    with pytest.raises(ValueError, match="multiple of 128"):
        cuda.ell_spmv_fused(x, cols[:, :64].contiguous(),
                            vals[:, :64].contiguous(), "min_plus")
    with pytest.raises(TypeError, match="dtype"):
        cuda.ell_spmv_fused(x, cols.long(), vals, "min_plus")
    with pytest.raises(ValueError, match="contiguous"):
        cuda.ell_spmv_fused(x, cols.t(), vals.t(), "min_plus")
    with pytest.raises(NotImplementedError, match="B4"):
        ops.ell_gather_fold(x, cols, vals, "min_plus")


@pytest.fixture(scope="module")
def store_path(tmp_path_factory):
    base = tmp_path_factory.mktemp("cuda_graph")
    src, dst = materialize(rmat_edges(scale=12, edge_factor=8, seed=3))
    write_edge_list(base / "el", [(src, dst)])
    preprocess_graph(str(base / "el"), str(base / "store"),
                     threshold_edge_num=4096)
    return str(base / "store")


@pytest.mark.parametrize("app", ["sssp", "bfs", "cc", "pagerank"])
def test_session_on_card_matches_cpu(dev, store_path, app):
    kw = dict(max_iters=15) if app == "pagerank" else {}
    with GraphSession(store_path, device="cpu") as s:
        want = s.run(app, **kw)
    with GraphSession(store_path) as s:
        runs = {}
        for fused in (True, False):
            for depth in (0, 2):
                cuda.reset_launches()
                cfg = s.config.replace(fused_gather=fused,
                                       prefetch_depth=depth)
                r = s.run(app, config=cfg, **kw)
                shards = sum(h.shards_processed for h in r.history)
                name = "ell_spmv_fused" if fused else "ell_fold"
                assert cuda.launches[name] == shards
                runs[fused, depth] = r
    for r in runs.values():
        assert r.iterations == want.iterations
        if app == "pagerank":
            np.testing.assert_allclose(r.values, want.values, rtol=2.1e-4)
        else:
            np.testing.assert_array_equal(r.values, want.values)
