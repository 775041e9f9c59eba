"""The CUDA kernels on the card, held against their plain torch versions on
the same card.  Marked ``cuda``: they skip without a GPU.  This file imports
no jax (the machine with the card has none).  Run it there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: min/max semirings bitwise (the kernels round op by op like the
plain version); plus semirings ``rtol=PLUS_RTOL`` (a row of W <= 512
positive float32 terms summed in another order: at most 512·2^-24);
personalized PageRank ``rtol=PPR_RTOL`` (that per-iteration bound, damped
by 1 / (1 - 0.85) over the run: ``tests/test_torch_batch.py``).
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core.semiring import SEMIRINGS
from repro_torch.core.shards import (CSRShard, csr_to_ell, quantize_edge_vals,
                                     quantize_shard)
from repro_torch.graph.generate import materialize, rmat_edges
from repro_torch.graph.preprocess import preprocess_graph
from repro_torch.graph.storage import write_edge_list
from repro_torch.kernels.spmv import cuda, ops, ref
from repro_torch.session import GraphSession

pytestmark = pytest.mark.cuda

SEMIS = list(SEMIRINGS)
PLUS_RTOL = 3.1e-5
PPR_RTOL = 2.1e-4


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


def _scattered(seed, dtype, num_rows=1000, n_src=50_000, width=512):
    """[R, W] edges of four kinds of rows, by row % 4: valid slots a prefix,
    valid slots scattered (not a prefix), all padding, all valid.
    -> (cols, vals, qparams)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_src, size=(num_rows, width)).astype(np.int32)
    deg = np.minimum(rng.zipf(1.8, size=num_rows), width)
    cols[0::4][np.arange(width) >= deg[0::4, None]] = -1
    cols[1::4][rng.random((len(cols[1::4]), width))
               < rng.random((len(cols[1::4]), 1))] = -1
    cols[2::4] = -1
    w = np.where(cols >= 0, rng.random(cols.shape) * 9 + 0.5,
                 0).astype(np.float32)
    vals, *qp = (w, 1.0, 0.0) if dtype == "float32" else \
        quantize_edge_vals(w, dtype)
    return cols, vals, tuple(qp)


def _unaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    skip = 1 + (-buf.data_ptr() // 4) % 4
    view = buf[skip:skip + t.numel()].view(t.shape)
    assert view.data_ptr() % 16 == 4
    return view.copy_(t)


@pytest.mark.parametrize("dtype", ["float32", "float16", "int8"])
@pytest.mark.parametrize("semiring", SEMIS)
@pytest.mark.parametrize("k", [2, 3, 4, 5, 8, 16, 17, 32, 33, 64])
def test_batch_kernels_match_plain(dev, k, semiring, dtype):
    """B1 at K > 1 and B3 against their plain versions, on a W = 512 tile
    with prefix, scattered, all-padding and full rows.  K % 4 == 0 with an
    aligned frontier takes float4 loads; K = 3, 5, 17, 33 and a frontier
    view 4 bytes past alignment take the scalar loads; K = 33 and 64 take
    more than one column chunk in the scalar path."""
    cols, vals, qp = _scattered(k + len(semiring), dtype)
    rng = np.random.default_rng(k)
    x = torch.from_numpy((rng.random((50_000, k)) * 100)
                         .astype(np.float32)).to(dev)
    if not SEMIRINGS[semiring].is_plus:
        x[torch.from_numpy(rng.random((50_000, k)) < 0.2).to(dev)] = \
            float("inf")
    cols = torch.from_numpy(cols).to(dev)
    vals = torch.from_numpy(vals).to(dev)
    xg = ref.gather(x, cols)
    want = ref.ell_fold_batch_ref(xg, ref.maybe_dequantize(vals, qp), cols,
                                  semiring)
    before = dict(cuda.launches)
    for xs, g in ((x, xg), (_unaligned(x), _unaligned(xg))):
        got = cuda.ell_spmv_fused_batch(xs, cols, vals, semiring, qp)
        _assert_close(got, want, semiring)
        got = cuda.ell_fold_batch(g, vals, cols, semiring, qp)
        torch.cuda.synchronize()
        _assert_close(got, want, semiring)
        assert got.shape == (cols.shape[0], k)
    assert cuda.launches["ell_spmv_fused_batch"] == \
        before["ell_spmv_fused_batch"] + 2
    assert cuda.launches["ell_fold_batch"] == before["ell_fold_batch"] + 2


def test_batch_wrappers_at_k1_take_the_single_column_kernels(dev):
    ell = _shard(2, "int8")
    x = torch.rand(50_000, 1, device=dev)
    cols = torch.from_numpy(ell.cols).to(dev)
    vals = torch.from_numpy(ell.vals).to(dev)
    qp = (ell.val_scale, ell.val_zero)
    before = dict(cuda.launches)
    got = cuda.ell_spmv_fused_batch(x, cols, vals, "min_plus", qp)
    want = cuda.ell_spmv_fused(x[:, 0].contiguous(), cols, vals, "min_plus",
                               qp)
    fold = cuda.ell_fold_batch(ref.gather(x, cols), vals, cols, "min_plus",
                               qp)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(fold, want)
    assert cuda.launches["ell_spmv_fused"] == before["ell_spmv_fused"] + 2
    assert cuda.launches["ell_fold"] == before["ell_fold"] + 1
    assert cuda.launches["ell_spmv_fused_batch"] == \
        before["ell_spmv_fused_batch"]


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
    with pytest.raises(ValueError, match="1-D"):
        ops.ell_gather_fold(x[None], cols, vals, "min_plus")
    with pytest.raises(ValueError, match="2-D"):
        cuda.ell_spmv_fused_batch(x, cols, vals, "min_plus")
    with pytest.raises(ValueError, match="first two dims"):
        cuda.ell_fold_batch(torch.ones(4, 128, 2, device=dev), vals, cols,
                            "min_plus")
    ext = ops.ell_row_extents(cols)
    with pytest.raises(ValueError, match="extents lie on cpu"):
        ops.ell_gather_fold(x, cols, vals, "min_plus", extents=ext.cpu())
    with pytest.raises(ValueError, match="extents have"):
        cuda.ell_gather_fold(x, cols, vals, "min_plus", extents=ext[1:])


@pytest.mark.parametrize("vb", [4096, 50_000])
@pytest.mark.parametrize("dtype", ["float32", "float16", "int8"])
@pytest.mark.parametrize("semiring", SEMIS)
def test_gather_fold_kernel_matches_plain(dev, semiring, dtype, vb):
    """B4 on a tile whose cols are local to a source block of 16 KB or
    200 KB, without and with the tile's row extents (on prefix rows, and on
    rows whose valid slots are scattered).  The block starts 3 floats into
    a larger array: B4 needs only float alignment."""
    ell = _shard(vb + len(semiring), dtype, n_src=vb)
    rng = np.random.default_rng(vb)
    x = torch.from_numpy((rng.random(vb + 7) * 100).astype(np.float32)).to(dev)
    if not SEMIRINGS[semiring].is_plus:
        x[torch.from_numpy(rng.random(vb + 7) < 0.2).to(dev)] = float("inf")
    x_blk = x[3:3 + vb]
    cols = torch.from_numpy(ell.cols).to(dev)
    vals = torch.from_numpy(ell.vals).to(dev)
    qp = (ell.val_scale, ell.val_zero)
    tiles = [(cols, vals, qp)]
    c, v, q = _scattered(vb, dtype, n_src=vb, width=256)
    tiles.append((torch.from_numpy(c).to(dev), torch.from_numpy(v).to(dev),
                  q))
    for cols, vals, qp in tiles:
        want = ops.ell_gather_fold(x_blk, cols, vals, semiring,
                                   use_kernel=False, qparams=qp)
        ext = ops.ell_row_extents(cols)
        for extents in (None, ext):
            before = cuda.launches["ell_gather_fold"]
            got = ops.ell_gather_fold(x_blk, cols, vals, semiring, qparams=qp,
                                      extents=extents)
            torch.cuda.synchronize()
            _assert_close(got, want, semiring)
            assert cuda.launches["ell_gather_fold"] == before + 1


def test_spmv_2d_on_card(dev):
    """spmv_2d on a 2 x 2 grid of lanes on one card, without and with the
    tiles' row extents: one B4 launch a tile, equal to the plain version
    (min_plus bitwise)."""
    from repro_torch.core.distributed import spmv_2d
    rng = np.random.default_rng(0)
    D, S, R, W, nloc = 2, 2, 4000, 256, 30_000
    cols = rng.integers(-1, nloc, size=(D, S, R, W)).astype(np.int32)
    cols[:, :, ::2, 40:] = -1  # short rows for the extents to cut
    vals = rng.random((D, S, R, W)).astype(np.float32)
    row_map = np.sort(rng.integers(0, R, size=(D, S, R)), -1).astype(np.int32)
    x = rng.random(S * nloc).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (x, cols, vals, row_map)]
    grid = [[torch.device("cuda", 0)] * S] * D
    ext = ops.ell_row_extents(args[1])
    for semiring in ("plus_times", "min_plus"):
        want = spmv_2d(*args, semiring, devices=grid, use_kernel=False)
        for extents in (None, ext):
            before = cuda.launches["ell_gather_fold"]
            got = spmv_2d(*args, semiring, devices=grid, extents=extents)
            assert cuda.launches["ell_gather_fold"] == before + D * S
            _assert_close(got, want, semiring)


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


@pytest.mark.parametrize("app,kw", [("sssp", {}), ("bfs", {}),
                                    ("ppr", dict(max_iters=10))])
def test_run_batch_on_card_matches_plain(dev, store_path, app, kw):
    """run_batch on the card through each kernel, against the plain version
    on the same card; one launch of the batched kernel per processed
    shard; sssp/bfs columns equal solo runs."""
    sources = [0, 7, 300, 1001, 4000, 2, 3, 64]
    with GraphSession(store_path) as s:
        plain = s.run_batch(app, sources=sources,
                            config=s.config.replace(use_kernel=False), **kw)
        for fused in (True, False):
            cuda.reset_launches()
            got = s.run_batch(app, sources=sources,
                              config=s.config.replace(fused_gather=fused),
                              **kw)
            shards = sum(h.shards_processed
                         for h in s.last_batch_result.history)
            name = "ell_spmv_fused_batch" if fused else "ell_fold_batch"
            assert cuda.launches[name] == shards > 0
            for g, w in zip(got, plain):
                assert g.iterations == w.iterations
                if app == "ppr":
                    np.testing.assert_allclose(g.values, w.values,
                                               rtol=PPR_RTOL, atol=0)
                else:
                    np.testing.assert_array_equal(g.values, w.values)
        if app != "ppr":
            for k in (0, 3):
                solo = s.run(app, source=sources[k])
                np.testing.assert_array_equal(got[k].values, solo.values)


def test_service_hammer_on_card(dev, store_path):
    """8 client threads, two runners sweeping at once on the card (sssp/bfs
    share one engine, ppr has its own): every sssp/bfs answer equals the
    solo run bitwise, every ppr answer its K = 1 run_batch to PPR_RTOL."""
    queries = [("sssp", dict(source=s)) for s in (0, 7, 300, 1001)] \
        + [("bfs", dict(source=s)) for s in (2, 3, 64, 4000)] \
        + [("ppr", dict(seed=s, max_iters=10)) for s in (0, 9, 500, 77)]
    queries = queries * 2  # repeats ride the same batches
    answers, errors = {}, []
    with GraphSession(store_path) as s:
        with s.service(max_batch=8, max_wait_ms=20.0, max_inflight=2,
                       memoize=False) as svc:
            def client(tid):
                try:
                    futs = [(i, svc.submit(app, **kw))
                            for i, (app, kw) in enumerate(queries)
                            if i % 8 == tid]
                    for i, f in futs:
                        answers[i] = f.result(timeout=300).values
                except BaseException as exc:  # noqa: BLE001 — checked below
                    errors.append(exc)

            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        assert not errors and not any(t.is_alive() for t in threads)
        for i, (app, kw) in enumerate(queries):
            if app == "ppr":
                want = s.run_batch("ppr", sources=[kw["seed"]],
                                   max_iters=10)[0].values
                np.testing.assert_allclose(answers[i], want, rtol=PPR_RTOL,
                                           atol=0)
            else:
                want = s.run(app, **kw).values
                np.testing.assert_array_equal(answers[i], want)


@pytest.mark.parametrize("depth", [0, 2])
def test_two_lane_session_on_card(dev, store_path, depth):
    """Two lanes on one card (each its own stream), through the fused
    kernels (B1) and through gather + fold (B2, B3): values and iteration
    counts equal the single-lane CPU run (PageRank to PPR_RTOL: the card's
    index_add_ adds in any order), per-lane disk bytes sum to the total,
    each kernel runs once per shard the lanes processed, and the batch's
    columns equal solo runs."""
    lanes = [torch.device("cuda", 0)] * 2
    runs = [("sssp", {}), ("bfs", dict(source=7)), ("cc", {}),
            ("pagerank", dict(max_iters=15))]
    sources = [0, 7, 300]
    with GraphSession(store_path, device="cpu") as s:
        want = {app: s.run(app, **kw) for app, kw in runs}
        want_cols = [s.run("sssp", source=v) for v in sources]
    with GraphSession(store_path, num_devices=2, device=lanes,
                      prefetch_depth=depth) as s:
        for fused in (True, False):
            cfg = s.config.replace(fused_gather=fused)
            name = "ell_spmv_fused" if fused else "ell_fold"
            for app, kw in runs:
                cuda.reset_launches()
                r = s.run(app, config=cfg, **kw)
                assert cuda.launches[name] == sum(
                    h.shards_processed for h in r.history) > 0
                assert all(sum(h.device_disk_bytes) == h.disk_bytes
                           and len(h.device_disk_bytes) == 2
                           for h in r.history)
                assert r.iterations == want[app].iterations
                if app == "pagerank":
                    np.testing.assert_allclose(r.values, want[app].values,
                                               rtol=PPR_RTOL)
                else:
                    np.testing.assert_array_equal(r.values, want[app].values)
            cuda.reset_launches()
            got = s.run_batch("sssp", sources=sources, config=cfg)
            assert cuda.launches[f"{name}_batch"] == sum(
                h.shards_processed for h in s.last_batch_result.history) > 0
            for g, w in zip(got, want_cols, strict=True):
                assert g.iterations == w.iterations
                np.testing.assert_array_equal(g.values, w.values)


def test_distributed_vsw_on_card(dev):
    from repro_torch.core.apps import get_app
    from repro_torch.core.distributed import DistributedVSW, partition_for_mesh
    src, dst = materialize(rmat_edges(scale=12, edge_factor=8, seed=5))
    g = partition_for_mesh(src, dst, 1 << 12, 2)
    for app in ("cc", "sssp"):
        on_cpu = DistributedVSW(g, get_app(app), ["cpu"] * 2).run(50)
        on_card = DistributedVSW(g, get_app(app),
                                 [torch.device("cuda", 0)] * 2).run(50)
        assert on_card[1] == on_cpu[1]
        np.testing.assert_array_equal(on_card[0], on_cpu[0])
