"""The port's multi-device engines (on CPU lanes) held against the reference.

The reference's multi-device side needs a jax mesh, so it runs once, in one
subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as
``tests/test_distributed.py`` does), and writes its outputs to an ``.npz``:
``GraphSession(num_devices=2 and 4)`` on a non-divisible store (n = 500,
scale 9, as ``tests/test_sharded_session.py`` builds it), ``run_batch``,
``DistributedVSW`` at D = 4 and ``spmv_2d`` at D = S = 2 on the seeded
inputs of ``tests/test_distributed.py``.  The port computes the same in
process on ``["cpu"] * D`` lanes.

Tolerances: BFS/SSSP/CC, the batched columns and min_plus bitwise, with
equal iteration counts and equal per-iteration stats (``device_*`` tuples
included) — min over the same float32 values is exact in any order and both
packages read the same shard bytes through the same cache partitions.
PageRank and plus_times within ``rtol=1e-5`` (``PLUS_RTOL``): the sums run in
another order, and at this size (rows of at most 256 terms, 20 damped
iterations) they stay well inside it.
Host-side pieces (``assign_shards``, ``partition_for_mesh``,
``PartitionedShardCache``) and B4's plain version run in process.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.kernels.spmv import ops as jops
from repro_torch.core.apps import get_app
from repro_torch.core.cache import PartitionedShardCache
from repro_torch.core.distributed import (DistributedVSW, ShardedVSWEngine,
                                          assign_shards, partition_for_mesh,
                                          spmv_2d)
from repro_torch.core.engine import EngineConfig
from repro_torch.core.semiring import SEMIRINGS
from repro_torch.dist.context import make_data_devices
from repro_torch.graph.storage import GraphStore
from repro_torch.kernels.spmv import ops
from repro_torch.session import GraphSession
from tests.test_torch_session import EXACT_FIELDS
from tests.test_torch_spmv import (DTYPES, SEMIS, _assert_matches, _frontier,
                                   _qp, _shard)

REPO = Path(__file__).resolve().parent.parent
PLUS_RTOL = 1e-5
APPS = {"pagerank": dict(max_iters=20, tol=1e-9), "sssp": dict(source=3),
        "bfs": dict(source=3), "cc": {}}
BATCH_SOURCES = [0, 3, 17]

# the reference side: every output the tests below compare, in one npz
_REFERENCE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.core import apps
from repro.core.distributed import DistributedVSW, partition_for_mesh, spmv_2d
from repro.graph.generate import rmat_edges, materialize
from repro.graph.preprocess import preprocess_graph
from repro.graph.storage import write_edge_list
from repro.session import GraphSession

base = sys.argv[1]
out = {}
src, dst = materialize(rmat_edges(scale=9, edge_factor=8, seed=7))
n = 500
keep = (src < n) & (dst < n)
src, dst = src[keep], dst[keep]
out["src"], out["dst"] = src, dst
write_edge_list(base + "/el", [(src, dst)])
preprocess_graph(base + "/el", base + "/store", threshold_edge_num=2048,
                 ell_max_width=256, num_vertices=n)
FIELDS = %(fields)r
APPS = %(apps)r


def stats(key, hist):
    out[key + "/stats"] = np.array([[getattr(h, f) for f in FIELDS]
                                    for h in hist], dtype=np.float64)
    out[key + "/ddisk"] = np.array([h.device_disk_bytes for h in hist])


for D in (2, 4):
    with GraphSession(base + "/store", num_devices=D, prefetch_depth=2) as s:
        for app, kw in APPS.items():
            r = s.run(app, **kw)
            out[f"{D}/{app}/values"] = np.asarray(r.values)
            out[f"{D}/{app}/iters"] = np.array([r.iterations, r.converged])
            stats(f"{D}/{app}", r.history)
        s.run_batch("sssp", sources=%(sources)r)
        r = s.last_batch_result
        out[f"{D}/batch/values"] = np.asarray(r.values)
        out[f"{D}/batch/iters"] = np.asarray(r.column_iterations)
        stats(f"{D}/batch", r.history)

mesh4 = jax.make_mesh((4,), ("data",),
                      axis_types=(jax.sharding.AxisType.Auto,))
g4 = partition_for_mesh(src, dst, n, 4)
for app in ("cc", "sssp", "pagerank"):
    prog = apps.sssp(source=3) if app == "sssp" else apps.get_app(app)
    vals, it = DistributedVSW(g4, prog, mesh4).run(30)
    out[f"dvsw/{app}/values"] = np.asarray(vals)
    out[f"dvsw/{app}/iters"] = np.array([it])

mesh22 = jax.make_mesh((2, 2), ("data", "model"),
                       axis_types=(jax.sharding.AxisType.Auto,) * 2)
for semiring, seed, nloc in (("plus_times", 0, 64), ("min_plus", 1, 48)):
    rng = np.random.default_rng(seed)
    D, S, R, W = 2, 2, 16, 128
    cols = rng.integers(-1, nloc, size=(D, S, R, W)).astype(np.int32)
    vals = rng.random((D, S, R, W)).astype(np.float32)
    row_map = np.sort(rng.integers(0, R, size=(D, S, R)), -1).astype(np.int32)
    x = rng.random(S * nloc).astype(np.float32)
    got = spmv_2d(jnp.asarray(x), jnp.asarray(cols), jnp.asarray(vals),
                  jnp.asarray(row_map), semiring, mesh22)
    for name, a in (("x", x), ("cols", cols), ("vals", vals),
                    ("row_map", row_map), ("out", np.asarray(got))):
        out[f"spmv2d/{semiring}/{name}"] = a
np.savez(base + "/reference.npz", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(store path, outputs of the reference's multi-device runs)."""
    base = tmp_path_factory.mktemp("distributed")
    code = _REFERENCE % dict(fields=EXACT_FIELDS, apps=APPS,
                             sources=BATCH_SOURCES)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = str(REPO / "src")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                        str(base)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-4000:]}"
    with np.load(base / "reference.npz") as z:
        return str(base / "store"), dict(z)


def _stats(hist):
    return (np.array([[getattr(h, f) for f in EXACT_FIELDS] for h in hist],
                     dtype=np.float64),
            np.array([h.device_disk_bytes for h in hist]))


@pytest.fixture(scope="module")
def port_runs(reference):
    """The reference's session runs, in its order (the apps share one
    warming cache), on ``["cpu"] * D`` lanes: {D: {app: result}}."""
    store, _ = reference
    runs = {}
    for D in (2, 4):
        with GraphSession(store, num_devices=D, prefetch_depth=2,
                          device=["cpu"] * D) as s:
            runs[D] = {app: s.run(app, **kw) for app, kw in APPS.items()}
            assert all(isinstance(s.engine(app), ShardedVSWEngine)
                       for app in APPS)
            runs[D]["columns"] = s.run_batch("sssp", sources=BATCH_SOURCES)
            runs[D]["batch"] = s.last_batch_result
            runs[D]["report"] = s.cache_report()
    return runs


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("app", list(APPS))
def test_sharded_session_matches_reference(reference, port_runs, app, D):
    _store, want = reference
    r = port_runs[D][app]
    key = f"{D}/{app}"
    assert [r.iterations, r.converged] == want[key + "/iters"].tolist()
    stats, ddisk = _stats(r.history)
    np.testing.assert_array_equal(ddisk, want[key + "/ddisk"])
    assert ddisk.shape == (r.iterations, D)
    np.testing.assert_array_equal(ddisk.sum(1), stats[:, 4])  # disk_bytes
    if app == "pagerank":
        np.testing.assert_allclose(r.values, want[key + "/values"],
                                   rtol=PLUS_RTOL, atol=0)
        return
    np.testing.assert_array_equal(r.values, want[key + "/values"])
    np.testing.assert_array_equal(stats, want[key + "/stats"])


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_run_batch_matches_reference(reference, port_runs, D):
    _store, want = reference
    r, cols, rep = (port_runs[D][k] for k in ("batch", "columns", "report"))
    np.testing.assert_array_equal(r.values, want[f"{D}/batch/values"])
    np.testing.assert_array_equal(r.column_iterations,
                                  want[f"{D}/batch/iters"])
    stats, ddisk = _stats(r.history)
    np.testing.assert_array_equal(stats, want[f"{D}/batch/stats"])
    np.testing.assert_array_equal(ddisk, want[f"{D}/batch/ddisk"])
    assert [c.values.tolist() for c in cols] == r.values.T.tolist()
    assert rep["policy"] == "partitioned" and rep["num_partitions"] == D
    assert len(rep["partitions"]) == D


@pytest.mark.parametrize("app", ["cc", "sssp", "pagerank"])
def test_distributed_vsw_matches_reference(reference, app):
    """D = 4 lanes on the port's partition, and on the reference's own
    ``DeviceShardedGraph`` (numpy arrays, passed in unchanged)."""
    _store, want = reference
    src, dst = want["src"], want["dst"]
    program = get_app(app, **(dict(source=3) if app == "sssp" else {}))
    for graph in (partition_for_mesh(src, dst, 500, 4),
                  jdist.partition_for_mesh(src, dst, 500, 4)):
        vals, it = DistributedVSW(graph, program, ["cpu"] * 4).run(30)
        assert it == int(want[f"dvsw/{app}/iters"][0])
        if app == "pagerank":
            np.testing.assert_allclose(vals, want[f"dvsw/{app}/values"],
                                       rtol=PLUS_RTOL, atol=0)
        else:
            np.testing.assert_array_equal(vals, want[f"dvsw/{app}/values"])


@pytest.mark.parametrize(
    "semiring,with_extents",
    [(s, e) for e in (False, True) for s in ("plus_times", "min_plus")],
    ids=["plus_times", "min_plus", "plus_times-extents", "min_plus-extents"])
def test_spmv_2d_matches_reference(reference, semiring, with_extents):
    """The tiles' cols hold -1 anywhere in a row, so their extents skip only
    each row's padding tail."""
    _store, want = reference
    args = [torch.from_numpy(want[f"spmv2d/{semiring}/{name}"])
            for name in ("x", "cols", "vals", "row_map")]
    ext = ops.ell_row_extents(args[1]) if with_extents else None
    got = spmv_2d(*args, semiring, devices=[["cpu"] * 2] * 2,
                  extents=ext).numpy()
    ref_out = want[f"spmv2d/{semiring}/out"].reshape(got.shape)
    if semiring == "plus_times":
        np.testing.assert_allclose(got, ref_out, rtol=PLUS_RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got, ref_out)
    # the same product with the plain version named explicitly
    plain = spmv_2d(*args, semiring, use_kernel=False, extents=ext).numpy()
    np.testing.assert_array_equal(plain, got)


def test_spmv_2d_rejects_bad_shapes():
    x = torch.ones(7)
    cols = torch.full((2, 2, 8, 128), -1, dtype=torch.int32)
    vals = torch.zeros(2, 2, 8, 128)
    rmap = torch.zeros(2, 2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple"):
        spmv_2d(x, cols, vals, rmap, "min_plus")
    with pytest.raises(ValueError, match="2 x 2 grid"):
        spmv_2d(torch.ones(8), cols, vals, rmap, "min_plus",
                devices=[["cpu"] * 2])
    ext = ops.ell_row_extents(cols)
    with pytest.raises(ValueError, match="extents lie on meta"):
        spmv_2d(torch.ones(8), cols, vals, rmap, "min_plus",
                extents=ext.to("meta"))
    with pytest.raises(ValueError, match="shape"):
        spmv_2d(torch.ones(8), cols, vals, rmap, "min_plus", extents=ext[0])


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("semiring", SEMIS)
def test_ell_gather_fold_matches_reference(semiring, dtype):
    """B4's plain version against the reference's Pallas kernel in
    interpret mode, on a tile with padding rows, all-``-1`` rows and -1
    sentinels, under ``tests/test_torch_spmv.py``'s rules: min/max bitwise
    but quantized min_plus within 1 ulp (XLA may contract the reference's
    dequantize multiply with the add), plus within its ``PLUS_RTOL``."""
    ell = _shard(13, 256, dtype)
    x_blk = _frontier(13, semiring)
    want = jops.ell_gather_fold(jnp.asarray(x_blk), jnp.asarray(ell.cols),
                                jnp.asarray(ell.vals), semiring,
                                use_pallas=True,
                                qparams=jnp.asarray(_qp(ell), jnp.float32))
    got = ops.ell_gather_fold(torch.from_numpy(x_blk),
                              torch.from_numpy(ell.cols),
                              torch.from_numpy(ell.vals), semiring,
                              qparams=_qp(ell)).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == (ell.shape[0], 1)
    _assert_matches(got, want, semiring, dtype)
    empty = (ell.cols < 0).all(1)
    assert empty.any() and (got[empty, 0] == SEMIRINGS[semiring].identity).all()


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
def test_assign_shards_matches_reference(graph_store, D):
    cases = [(np.asarray(graph_store.intervals),
              [int(m["nnz"]) for m in graph_store.properties["shards"]]),
             (np.array([0, 10, 30, 60, 100, 130, 150]), [10, 20, 30, 40, 20, 20]),
             (np.array([0, 7, 19]), [5, 5]),
             (np.array([0, 5, 10, 15, 20]), [0, 0, 0, 0])]
    for intervals, nnz in cases:
        got, want = (assign_shards(intervals, nnz, D),
                     jdist.assign_shards(intervals, nnz, D))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


@pytest.mark.parametrize("D", [2, 4, 8])
def test_partition_for_mesh_matches_reference(small_graph, D):
    src, dst, _ = small_graph
    n = 500
    keep = (src < n) & (dst < n)
    src, dst = src[keep], dst[keep]
    got = partition_for_mesh(src, dst, n, D)
    want = jdist.partition_for_mesh(src, dst, n, D)
    for field in ("num_vertices", "padded_num_vertices", "num_edges",
                  "rows_per_device"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("cols", "vals", "row_map", "out_deg"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype, field
        np.testing.assert_array_equal(g, w)
    assert len(got.blooms) == len(want.blooms) == D
    for g, w in zip(got.blooms, want.blooms):
        assert (g.num_bits, g.num_hashes) == (w.num_bits, w.num_hashes)
        np.testing.assert_array_equal(g.bits, w.bits)


def test_partitioned_cache_budget_and_routing(graph_store):
    store = GraphStore(graph_store.path)
    P_ = store.num_shards
    owner = np.arange(P_, dtype=np.int64) % 3
    budget = 1 << 20
    pc = PartitionedShardCache(store, owner, 3, budget_bytes=budget)
    # the per-partition budgets split the global one EXACTLY
    assert sum(p.budget for p in pc.parts) == budget == pc.budget
    for p in range(P_):
        shard = pc.get(p)
        assert shard.start_vertex == store.intervals[p]
        # the fetch landed in the owner's partition only
        assert pc.parts[owner[p]].stats.misses >= 1
    assert pc.stats.misses == P_
    pc.get(0)
    assert pc.stats.hits >= 1
    rep = pc.report()
    assert rep["policy"] == "partitioned" and rep["num_partitions"] == 3
    assert len(rep["partitions"]) == 3
    assert pc.cached_bytes == sum(p.cached_bytes for p in pc.parts)
    # frozen store: nothing is epoch-stale, so a bare invalidate is a no-op
    assert pc.invalidate() == 0
    assert pc.invalidate(range(P_)) == P_
    assert pc.cached_shards == 0
    with pytest.raises(ValueError):
        PartitionedShardCache(store, owner, 2)  # owner id out of range


# ---------------------------------------------------------------------------
def test_make_data_devices():
    assert make_data_devices(3, "cpu") == [torch.device("cpu")] * 3
    assert make_data_devices(2, ["cpu", "cpu"]) == [torch.device("cpu")] * 2
    assert make_data_devices(1, "cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="num_devices"):
        make_data_devices(0, "cpu")
    with pytest.raises(ValueError, match="names 1 lanes"):
        make_data_devices(2, ["cpu"])
    with pytest.raises(ValueError, match="pass a list"):
        make_data_devices(2, "cuda:0")
    # more CUDA lanes than visible GPUs: raises, naming the explicit list
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=r"\['cuda:0'\] \*"):
        make_data_devices(max(2, visible + 1), "cuda")


def test_engine_config_num_devices_and_env(graph_store, monkeypatch):
    assert EngineConfig(num_devices=4).num_devices == 4
    for bad in (0, -1, True, 1.5, "8"):
        with pytest.raises(ValueError):
            EngineConfig(num_devices=bad)
    monkeypatch.setenv("GRAPHMP_DEVICES", "2")
    with GraphSession(str(graph_store.path), device="cpu") as s:
        assert s.config.num_devices == 2 and len(s.devices) == 2
        r = s.run("cc")
        assert isinstance(s.engine("cc"), ShardedVSWEngine)
        assert len(r.history[0].device_disk_bytes) == 2
        # a per-run config may ask for one lane: the single-device engine
        one = s.run("cc", config=s.config.replace(num_devices=1))
        np.testing.assert_array_equal(one.values, r.values)
        assert one.history[0].device_disk_bytes == ()


def test_sharded_checkpoint_resumes_on_one_lane(graph_store, tmp_path):
    """State is lane-free: a D = 2 run checkpointed midway resumes on one
    lane to the values of an uninterrupted run."""
    path = str(graph_store.path)
    with GraphSession(path, device=["cpu"] * 2, num_devices=2) as s:
        s.run("sssp", source=5, max_iters=2, checkpoint_dir=str(tmp_path),
              checkpoint_every=1)
    with GraphSession(path, device="cpu") as s:
        resumed = s.run("sssp", source=5, checkpoint_dir=str(tmp_path),
                        resume=True)
        whole = s.run("sssp", source=5)
    np.testing.assert_array_equal(resumed.values, whole.values)
    assert resumed.history[0].iteration == 2
