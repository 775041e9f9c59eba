"""The port's batched path (K frontier columns per sweep), on the CPU, held
against the reference package on the same numpy inputs.

Kernel functions: the port's plain versions against the reference's Pallas
kernels ``ell_spmv_fused_pallas`` (K columns) and ``ell_fold_batch_pallas``
run in interpret mode, and against its jnp path ``ell_spmv_batch``.
Tolerances are those of ``test_torch_spmv.py``: min/max semirings bitwise,
quantized min_plus within 1 ulp (XLA may contract the dequantize multiply
with min_plus's add), plus semirings ``rtol=PLUS_RTOL``.

``run_batch``: SSSP/BFS values bitwise and every non-seconds
``IterationStats`` field, the per-column iteration counts and convergence
flags equal, over cache mode {0, adaptive} x prefetch {0, 2}.
Personalized PageRank is a plus semiring: a fixed ``max_iters`` and a tiny
``tol`` keep both packages on the same iterations, and values are held to
``PPR_RTOL``.  Each value is a sum of positive float32 terms, at most
2·W = 512 per iteration (a row plus its wrapped rows), so one iteration
differs by at most 512·2^-24 ≈ 3.1e-5 relative when the sums run in another
order; the damped iteration (factor 0.85) lets that accumulate to at most
1/(1 - 0.85) ≈ 6.7 times as much: 2.1e-4.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.apps import list_apps as ref_list_apps
from repro.kernels.spmv import ops as jops
from repro.kernels.spmv import ref as jref
from repro.kernels.spmv import spmv as jspmv
from repro.session import GraphSession as RefSession
from repro_torch.core.apps import batch_spec, get_app, list_apps
from repro_torch.core.engine import BatchRunResult
from repro_torch.core.semiring import SEMIRINGS
from repro_torch.kernels.spmv import ops, ref
from repro_torch.session import GraphSession
from repro_torch.state import state_from_numpy, state_to_numpy
from tests.test_torch_session import EXACT_FIELDS
from tests.test_torch_spmv import (DTYPES, N_SRC, SEMIS, _assert_matches, _qp,
                                   _shard)

PPR_RTOL = 2.1e-4
KS = [1, 3, 16]


def _frontier(seed: int, semiring: str, k: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    x = (rng.random((N_SRC, k)) * 100).astype(np.float32)
    if not SEMIRINGS[semiring].is_plus:
        x[rng.random((N_SRC, k)) < 0.2] = np.inf  # unreached vertices
    return x


def _jqp(ell):
    return jnp.asarray(_qp(ell), jnp.float32)


# ---------------------------------------------------------------------------
# kernel functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("semiring", SEMIS)
@pytest.mark.parametrize("k", KS)
def test_ell_spmv_batch_matches_reference(k, semiring, dtype):
    """The port's ell_spmv_batch (plain, CPU) against the reference's jnp
    ell_spmv_batch; its partials against ell_spmv_fused_pallas at K."""
    ell = _shard(128 + k, 128, dtype)
    x = _frontier(k, semiring, k)
    R = ell.shape[0]
    cols, vals = torch.from_numpy(ell.cols), torch.from_numpy(ell.vals)
    got = ops.ell_spmv_batch(torch.from_numpy(x), cols, vals,
                             torch.from_numpy(ell.row_map), R, semiring,
                             qparams=_qp(ell))
    want = jops.ell_spmv_batch(jnp.asarray(x), jnp.asarray(ell.cols),
                               jnp.asarray(ell.vals),
                               jnp.asarray(ell.row_map), R, semiring,
                               use_pallas=False, qparams=_jqp(ell))
    assert got.shape == (R, k)
    _assert_matches(got.numpy(), np.asarray(want), semiring, dtype)
    partials = ref.ell_fold_batch_ref(
        ref.gather(torch.from_numpy(x), cols),
        ref.maybe_dequantize(vals, _qp(ell)), cols, semiring)
    want = jspmv.ell_spmv_fused_pallas(
        jnp.asarray(x), jnp.asarray(ell.cols), jnp.asarray(ell.vals),
        semiring, interpret=True, qparams=_jqp(ell))
    _assert_matches(partials.numpy(), np.asarray(want), semiring, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("semiring", SEMIS)
@pytest.mark.parametrize("k", KS)
def test_ell_fold_batch_matches_reference(k, semiring, dtype):
    """ell_fold_batch_ref against ell_fold_batch_pallas on [R, W, K]."""
    ell = _shard(256 + k, 128, dtype)
    x = _frontier(k + 7, semiring, k)
    xg = x[np.where(ell.cols >= 0, ell.cols, 0)]
    got = ref.ell_fold_batch_ref(
        torch.from_numpy(xg),
        ref.maybe_dequantize(torch.from_numpy(ell.vals), _qp(ell)),
        torch.from_numpy(ell.cols), semiring)
    want = jspmv.ell_fold_batch_pallas(
        jnp.asarray(xg), jnp.asarray(ell.vals), jnp.asarray(ell.cols),
        semiring, interpret=True, qparams=_jqp(ell))
    assert got.shape == (ell.shape[0], k)
    _assert_matches(got.numpy(), np.asarray(want), semiring, dtype)


@pytest.mark.parametrize("semiring", SEMIS)
def test_segment_combine_batch_matches_reference(semiring):
    """Unsorted row_map (padding rows point at 0) and empty segments, which
    must hold the identity in every column."""
    rng = np.random.default_rng(9)
    R, K, num_segments = 64, 3, 80
    partials = (rng.random((R, K)) * 10).astype(np.float32)
    row_map = rng.integers(0, 40, size=R).astype(np.int32)
    row_map[-8:] = 0
    want = jref.segment_combine_batch(jnp.asarray(partials),
                                      jnp.asarray(row_map), num_segments,
                                      semiring)
    got = ref.segment_combine_batch(torch.from_numpy(partials),
                                    torch.from_numpy(row_map), num_segments,
                                    semiring)
    _assert_matches(got.numpy(), np.asarray(want), semiring, "float32")
    empty = np.setdiff1d(np.arange(num_segments), row_map)
    assert (got.numpy()[empty] == SEMIRINGS[semiring].identity).all()


@pytest.mark.parametrize("semiring", SEMIS)
def test_batch_column_equals_single_column(semiring):
    """Column k of ell_spmv_batch is ell_spmv of column k: bitwise for
    min/max semirings, within ``PLUS_RTOL`` for plus semirings (torch sums
    a [R, W, K] and an [R, W] tensor over W in different orders)."""
    ell = _shard(5, 128, "float16")
    x = _frontier(5, semiring, 4)
    args = (torch.from_numpy(ell.cols), torch.from_numpy(ell.vals),
            torch.from_numpy(ell.row_map), ell.shape[0], semiring)
    batch = ops.ell_spmv_batch(torch.from_numpy(x), *args, qparams=_qp(ell))
    for k in range(4):
        single = ops.ell_spmv(torch.from_numpy(np.ascontiguousarray(x[:, k])),
                              *args, qparams=_qp(ell))
        _assert_matches(batch[:, k].numpy(), single.numpy(), semiring,
                        "float32")


def test_batch_dispatch_on_cpu():
    assert ops.describe_dispatch("auto", device="cpu", k=16) == "torch"
    assert ops.describe_dispatch("auto", device="cuda", k=16) == "cuda:fused"
    assert ops.describe_dispatch(True, device="cuda", k=3,
                                 fused=False) == "cuda:gather+fold"
    with pytest.raises(ValueError, match="k must be"):
        ops.describe_dispatch("auto", device="cpu", k=0)
    ell = _shard(1, 128, "float32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.ell_spmv_batch(torch.ones(N_SRC, 4), torch.from_numpy(ell.cols),
                           torch.from_numpy(ell.vals),
                           torch.from_numpy(ell.row_map), ell.shape[0],
                           "min_plus", use_kernel=True)


# ---------------------------------------------------------------------------
# run_batch against the reference
# ---------------------------------------------------------------------------
def _sources(n):
    return [0, 3, (n * 2) // 3, n - 1, 17]


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("cache_mode", [0, "auto"])
@pytest.mark.parametrize("app", ["sssp", "bfs"])
def test_run_batch_matches_reference(graph_store, app, cache_mode, prefetch):
    kw = dict(cache_mode=cache_mode, prefetch_depth=prefetch,
              cache_budget_bytes=1 << 20)
    sources = _sources(graph_store.num_vertices)
    with RefSession(str(graph_store.path), **kw) as s:
        want_cols = s.run_batch(app, sources=sources)
        want = s.last_batch_result
    with GraphSession(str(graph_store.path), device="cpu", **kw) as s:
        got_cols = s.run_batch(app, sources=sources)
        got = s.last_batch_result
    assert isinstance(got, BatchRunResult)
    assert got.values.dtype == np.float32
    assert got.values.shape == (graph_store.num_vertices, len(sources))
    np.testing.assert_array_equal(got.values, want.values)
    assert (got.iterations, got.converged, got.tag) == \
        (want.iterations, want.converged, want.tag)
    np.testing.assert_array_equal(got.column_iterations,
                                  want.column_iterations)
    np.testing.assert_array_equal(got.column_converged, want.column_converged)
    assert len(got.history) == len(want.history)
    for g, w in zip(got.history, want.history):
        for field in EXACT_FIELDS:
            assert getattr(g, field) == getattr(w, field), field
    for g, w in zip(got_cols, want_cols):
        np.testing.assert_array_equal(g.values, w.values)
        assert (g.iterations, g.converged, len(g.history)) == \
            (w.iterations, w.converged, len(w.history))


@pytest.mark.parametrize("app,kw", [
    ("ppr", dict(sources=[3, 11, 29])),
    ("personalized_pagerank", dict(seeds=[0, 7], damping=0.9)),
])
def test_ppr_within_tolerance(graph_store, app, kw):
    run = dict(max_iters=10, tol=1e-9, **kw)
    with RefSession(str(graph_store.path)) as s:
        want = s.run_batch(app, **run)
    with GraphSession(str(graph_store.path), device="cpu") as s:
        got = s.run_batch(app, **run)
        combined = s.last_batch_result
    assert combined.iterations == 10 and not combined.converged
    for g, w in zip(got, want):
        assert g.iterations == w.iterations
        np.testing.assert_allclose(g.values, w.values, rtol=PPR_RTOL, atol=0)
    seeds = kw.get("sources", kw.get("seeds"))
    for k, seed in enumerate(seeds):  # mass concentrates near the seed
        assert got[k].values[seed] > np.median(got[k].values)


@pytest.mark.parametrize("app", ["sssp", "bfs"])
def test_run_batch_columns_equal_solo_runs(graph_store, app):
    """Each column equals the port's own solo run bitwise, in values and in
    iteration count, and the engine is shared by every source set of one
    K."""
    sources = _sources(graph_store.num_vertices)
    with GraphSession(str(graph_store.path), device="cpu") as s:
        batch = s.run_batch(app, sources=sources)
        combined = s.last_batch_result
        for k, src in enumerate(sources):
            solo = s.run(app, source=src)
            np.testing.assert_array_equal(batch[k].values, solo.values)
            assert batch[k].iterations == solo.iterations
            assert batch[k].converged and len(batch[k].history) == \
                batch[k].iterations
        assert s.engine(f"{app}_multi", sources=sources).last_result \
            is combined
        assert s.engine("sssp_multi", sources=sources[::-1]) is \
            s.engine("bfs_multi", sources=sources)


def test_fused_gather_switch_gives_identical_batches(graph_store):
    with GraphSession(str(graph_store.path), device="cpu") as s:
        a = s.run_batch("bfs", sources=[1, 2, 3])
        b = s.run_batch("bfs", sources=[1, 2, 3],
                        config=s.config.replace(fused_gather=False))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.values, y.values)


def _ref_session(path):
    return RefSession(path, cache_mode=0)


def _port_session(path):
    return GraphSession(path, device="cpu", cache_mode=0)


@pytest.mark.parametrize("writer,reader", [(_ref_session, _port_session),
                                           (_port_session, _ref_session)],
                         ids=["repro_to_port", "port_to_repro"])
def test_batched_checkpoint_resumes_across_packages(graph_store, tmp_path,
                                                    writer, reader):
    path = str(graph_store.path)
    sources = [0, 9, 200]
    with _ref_session(path) as s:
        s.run_batch("sssp", sources=sources)
        cold = s.last_batch_result
    assert cold.iterations > 2
    ck = str(tmp_path / "ck")
    with writer(path) as s:
        s.run_batch("sssp", sources=sources, max_iters=2, checkpoint_dir=ck)
        assert s.last_batch_result.iterations == 2
    with reader(path) as s:
        s.run_batch("sssp", sources=sources, checkpoint_dir=ck, resume=True)
        rest = s.last_batch_result
    assert rest.iterations == cold.iterations - 2
    np.testing.assert_array_equal(rest.values, cold.values)
    np.testing.assert_array_equal(rest.column_iterations,
                                  cold.column_iterations)
    with pytest.raises(ValueError, match="different run"):
        with reader(path) as s:
            s.run_batch("sssp", sources=[0, 9, 201], checkpoint_dir=ck,
                        resume=True)


def test_run_batch_argument_validation(graph_store):
    sess = GraphSession(str(graph_store.path), device="cpu")
    with pytest.raises(TypeError, match="needs sources"):
        sess.run_batch("sssp")
    with pytest.raises(TypeError, match="not a batched application"):
        sess.run_batch("cc", sources=[0])
    with pytest.raises(ValueError, match="at least one source"):
        get_app("sssp_multi", sources=())
    with pytest.raises(ValueError, match=">= 0"):
        sess.run_batch("sssp", sources=[0, -1])
    with pytest.raises(TypeError, match="not both"):
        sess.run_batch("ppr", sources=[1], seeds=[2])
    with pytest.raises(TypeError, match="damping"):
        sess.run_batch("sssp", sources=[0], damping=0.5)
    prog = get_app("sssp_multi", sources=(0, 1))
    with pytest.raises(TypeError, match="already fixes its frontiers"):
        sess.run_batch(prog, sources=[2])
    with pytest.raises(TypeError, match="only apply when dispatching by name"):
        sess.run_batch(prog, damping=0.5)
    # a constructed program runs as well as a name
    cols = sess.run_batch(prog)
    assert len(cols) == 2 and sess.last_batch_result.num_columns == 2


@pytest.mark.parametrize("app", ["lp", "kcore", "triangle_count",
                                 "random_walk", "lp_multi", "kcore_multi",
                                 "triangles_multi", "random_walks",
                                 "triangles"])
def test_unported_batched_apps_name_their_roadmap_item(graph_store, app):
    with GraphSession(str(graph_store.path), device="cpu") as s:
        with pytest.raises(NotImplementedError, match="A7"):
            s.run_batch(app, sources=[0])


def test_batched_state_round_trip():
    rng = np.random.default_rng(1)
    values = rng.random((37, 4)).astype(np.float32)
    values[3, 1] = np.inf
    active = rng.random((37, 4)) < 0.5
    v, a = state_from_numpy(values, active, "cpu", n_pad=45)
    assert v.shape == (45, 4) and a.shape == (37, 4)
    assert (v[37:] == 0).all()
    back_v, back_a = state_to_numpy(v, a, 37)
    np.testing.assert_array_equal(back_v, values)
    np.testing.assert_array_equal(back_a, active)
    with pytest.raises(ValueError, match=r"\[n, K\]"):
        state_from_numpy(values, active[:, :3], "cpu")


def test_serving_metadata_matches_reference():
    """The port's registry reports the reference's kind and family for
    every name it carries, and batch specs exist for sssp/bfs/ppr only."""
    want = {i.name: i for i in ref_list_apps()}
    got = {i.name: i for i in list_apps()}
    assert {"sssp_multi", "bfs_multi", "personalized_pagerank",
            "ppr"} <= set(got)
    for name, info in got.items():
        assert dataclasses.astuple(info) == dataclasses.astuple(want[name])
    assert {n for n in got if batch_spec(n)} == {"sssp", "bfs", "ppr"}
    assert batch_spec("ppr").exact is False and batch_spec("lp") is None
