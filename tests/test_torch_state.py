"""State that crosses the two packages: checkpoints, preprocessed stores
and generated graphs.

A checkpoint written by one package must resume in the other and finish
with bitwise the values a cold run gives (the apps here are min-semiring
apps, exact in any summation order).  A graph preprocessed by each package
from the same edge list must decode to identical arrays, and both
packages' RMAT generators must stream identical edges.
"""
import json

import numpy as np
import pytest
import torch

from repro.graph.generate import rmat_edges as ref_rmat_edges
from repro.graph.preprocess import preprocess_graph as ref_preprocess
from repro.graph.storage import GraphStore as RefStore
from repro.graph.storage import write_edge_list
from repro.session import GraphSession as RefSession
from repro_torch.graph.generate import rmat_edges
from repro_torch.graph.preprocess import preprocess_graph
from repro_torch.graph.storage import GraphStore
from repro_torch.session import GraphSession
from repro_torch.state import state_from_numpy, state_to_numpy


def _ref_session(path):
    return RefSession(path, cache_mode=0)


def _port_session(path):
    return GraphSession(path, device="cpu", cache_mode=0)


@pytest.mark.parametrize("app,kw", [("sssp", dict(source=2)), ("cc", {})])
@pytest.mark.parametrize("writer,reader", [(_ref_session, _port_session),
                                           (_port_session, _ref_session)],
                         ids=["repro_to_port", "port_to_repro"])
def test_checkpoint_resumes_across_packages(graph_store, tmp_path, app, kw,
                                            writer, reader):
    path = str(graph_store.path)
    with _ref_session(path) as s:
        cold = s.run(app, **kw)
    assert cold.iterations > 2
    ck = str(tmp_path / "ck")
    with writer(path) as s:
        part = s.run(app, max_iters=2, checkpoint_dir=ck, **kw)
    assert part.iterations == 2 and not part.converged
    with reader(path) as s:
        rest = s.run(app, checkpoint_dir=ck, resume=True, **kw)
    assert rest.iterations == cold.iterations - 2
    np.testing.assert_array_equal(rest.values, cold.values)


def test_checkpoint_from_other_program_is_refused(graph_store, tmp_path):
    ck = str(tmp_path / "ck")
    with _ref_session(str(graph_store.path)) as s:
        s.run("sssp", source=2, max_iters=1, checkpoint_dir=ck)
    with _port_session(str(graph_store.path)) as s:
        with pytest.raises(ValueError, match="different run"):
            s.run("sssp", source=4, checkpoint_dir=ck, resume=True)


@pytest.mark.parametrize("val_dtype,weighted", [("float32", False),
                                                ("float32", True),
                                                ("float16", True),
                                                ("int8", True)])
def test_preprocess_gives_identical_stores(tmp_path, small_graph, val_dtype,
                                           weighted):
    src, dst, _ = small_graph
    write_edge_list(tmp_path / "el", [(src, dst)], weighted=weighted, seed=4)
    kw = dict(threshold_edge_num=1500, ell_max_width=256, val_dtype=val_dtype)
    ref_preprocess(str(tmp_path / "el"), str(tmp_path / "a"), **kw)
    preprocess_graph(str(tmp_path / "el"), str(tmp_path / "b"), **kw)
    a, b = RefStore(tmp_path / "a"), GraphStore(tmp_path / "b")
    pa, pb = (json.loads((tmp_path / d / "property.json").read_text())
              for d in "ab")
    pa.pop("preprocess_seconds"), pb.pop("preprocess_seconds")
    assert pa == pb and pa["num_shards"] > 2
    np.testing.assert_array_equal(a.intervals, b.intervals)
    for x, y in zip(a.read_vertex_info(), b.read_vertex_info()):
        np.testing.assert_array_equal(x, y)
    for p in range(a.num_shards):
        sa, sb = a.read_shard(p), b.read_shard(p)
        for field in ("cols", "vals", "row_map"):
            x, y = getattr(sa, field), getattr(sb, field)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        assert (sa.start_vertex, sa.end_vertex, sa.nnz, sa.val_scale,
                sa.val_zero) == (sb.start_vertex, sb.end_vertex, sb.nnz,
                                 sb.val_scale, sb.val_zero)
        ba, bb = a.read_bloom(p), b.read_bloom(p)
        np.testing.assert_array_equal(ba.bits, bb.bits)
        assert (ba.num_bits, ba.num_hashes) == (bb.num_bits, bb.num_hashes)


def test_state_round_trip():
    rng = np.random.default_rng(0)
    values = rng.random(37).astype(np.float32)
    values[3] = np.inf
    active = rng.random(37) < 0.5
    v, a = state_from_numpy(values, active, "cpu", n_pad=45)
    assert v.shape == (45,) and v.dtype == torch.float32
    assert a.dtype == torch.bool and (v[37:] == 0).all()
    back_v, back_a = state_to_numpy(v, a, 37)
    np.testing.assert_array_equal(back_v, values)
    np.testing.assert_array_equal(back_a, active)
    with pytest.raises(ValueError, match="n_pad"):
        state_from_numpy(values, active, "cpu", n_pad=10)
    with pytest.raises(ValueError, match=r"\[n\]"):
        state_from_numpy(values, active[:-1], "cpu")


@pytest.mark.parametrize("kw", [
    dict(scale=9, edge_factor=8, seed=7),
    dict(scale=14, edge_factor=16, a=0.57, b=0.19, c=0.19, seed=0,
         chunk=1 << 13),
    dict(scale=5, edge_factor=3, a=0.45, b=0.15, c=0.15, seed=2, chunk=7),
], ids=["conftest", "graph500-chunked", "skewed-odd-chunk"])
def test_rmat_edges_match_reference(kw):
    """The port draws each quadrant from the reference's random stream
    without ``rng.choice``: the same chunks, int64, bitwise."""
    got, want = list(rmat_edges(**kw)), list(ref_rmat_edges(**kw))
    assert len(got) == len(want)
    for (gs, gd), (ws, wd) in zip(got, want):
        assert gs.dtype == gd.dtype == ws.dtype == np.int64
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gd, wd)
