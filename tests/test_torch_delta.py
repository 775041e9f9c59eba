"""The port's mutable graph (``DeltaGraphStore``, ``apply_mutations``,
``run_incremental``, ``compact``) held against the reference package's on
the CPU, with the same edit batches applied to both.

* Store state after every commit equals the reference's: ``epoch``,
  ``shard_epoch``, ``dirty_shards``, ``properties``, degrees, Bloom bits and
  ``read_shard_bytes`` of every shard (float32 and int8/float16 stores),
  ``affected_sources_since`` and ``monotone_since``.
* Runs: BFS/SSSP/CC bitwise with every non-seconds ``IterationStats`` field
  equal, PageRank within ``PR_RTOL`` (``tests/test_torch_session.py``).
  A run on the overlay equals a run on the pre-merged frozen store, and
  ``run_incremental`` equals both the reference's and a cold run.
* Compaction writes the reference's bytes on every backend; the budget,
  the mid-run epoch pin, the service's memo refresh and the multi-lane
  session behave as the reference's do.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.graph import delta as jdelta
from repro.graph.compact import compact as ref_compact
from repro.graph.delta import DeltaBudgetError as RefBudgetError
from repro.graph.delta import DeltaGraphStore as RefDeltaStore
from repro.graph.storage import GraphStore as RefGraphStore
from repro.session import GraphSession as RefSession
from repro_torch.graph import delta as tdelta
from repro_torch.graph.compact import compact
from repro_torch.graph.delta import (DeltaBudgetError, DeltaGraphStore,
                                     _ell_to_csr_triples)
from repro_torch.graph.packed import pack_graph
from repro_torch.graph.source import ConcurrentMutationError
from repro_torch.graph.storage import GraphStore
from repro_torch.session import GraphSession
from tests._hypo import HAVE_HYPOTHESIS, given, settings, st
from tests.test_delta import (N, THRESH, _fresh_inserts, _merged,
                              _preprocess, _random_edges)
from tests.test_torch_session import EXACT_FIELDS, PR_RTOL

REPO = Path(__file__).resolve().parent.parent
EXACT_APPS = (("sssp", {"source": 0}), ("bfs", {"source": 0}), ("cc", {}))


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """(base_dir, merged_dir, base edges, inserts); the base directory also
    holds its packed file, so neither package packs it again."""
    tmp = tmp_path_factory.mktemp("torch_delta")
    src, dst, w = _random_edges(0)
    inserts = _fresh_inserts(0, src, dst)
    base = _preprocess(tmp, "base", src, dst, w)
    pack_graph(GraphStore(base))
    merged = _preprocess(tmp, "merged", *_merged(src, dst, w, inserts))
    return base, merged, (src, dst, w), inserts


def _sessions(path, **kw):
    """(reference session, port session) over ``path`` with ``kw``."""
    return RefSession(path, **kw), GraphSession(path, device="cpu", **kw)


def _assert_same_store(port, ref):
    """Every observable of the port's store equals the reference's (the
    overlay's ``dirty_shards`` too, where the store is one)."""
    assert port.epoch() == ref.epoch()
    if isinstance(port, DeltaGraphStore):
        assert port.dirty_shards() == ref.dirty_shards()
    assert port.properties == ref.properties
    for p in range(ref.num_shards):
        assert port.shard_epoch(p) == ref.shard_epoch(p)
        assert port.shard_nbytes(p) == ref.shard_nbytes(p)
        assert port.read_shard_bytes(p) == ref.read_shard_bytes(p), p
        np.testing.assert_array_equal(port.read_bloom(p).bits,
                                      ref.read_bloom(p).bits)
    for a, b in zip(port.read_vertex_info(), ref.read_vertex_info()):
        np.testing.assert_array_equal(a, b)


def _assert_same_run(got, want):
    assert (got.iterations, got.converged, got.epoch, got.tag) == \
        (want.iterations, want.converged, want.epoch, want.tag)
    np.testing.assert_array_equal(got.values, want.values)
    assert len(got.history) == len(want.history)
    for g, w in zip(got.history, want.history):
        for field in EXACT_FIELDS:
            assert getattr(g, field) == getattr(w, field), field


# ---------------------------------------------------------------------------
# the overlay, across backends / cache modes / prefetch depths
# ---------------------------------------------------------------------------
MATRIX = [pytest.param(b, d, m, id=f"{b}-depth{d}-mode{m}")
          for b in ("npz", "packed", "memory")
          for d, m in ((0, "auto"), (2, "auto"), (0, 0))]


@pytest.mark.parametrize("backend,depth,mode", MATRIX)
def test_overlay_matches_reference(graphs, backend, depth, mode):
    base, merged, (src, dst, _w), inserts = graphs
    ref, sess = _sessions(base, backend=backend, mutable=True,
                          prefetch_depth=depth, cache_mode=mode,
                          selective_threshold=THRESH)
    frozen = GraphSession(merged, device="cpu", selective_threshold=THRESH)
    with ref, sess, frozen:
        assert isinstance(sess.store, DeltaGraphStore)
        assert sess.apply_mutations(inserts=inserts) == \
            ref.apply_mutations(inserts=inserts) == 1
        _assert_same_store(sess.store, ref.store)
        for app, kw in EXACT_APPS:
            got = sess.run(app, **kw)
            _assert_same_run(got, ref.run(app, **kw))
            # the overlay equals the pre-merged frozen store
            np.testing.assert_array_equal(got.values,
                                          frozen.run(app, **kw).values)
        np.testing.assert_allclose(sess.run("pagerank", max_iters=15).values,
                                   ref.run("pagerank", max_iters=15).values,
                                   rtol=PR_RTOL)
        assert sess.store.num_edges == frozen.store.num_edges
        # a second commit with an upsert and a delete
        edits = dict(updates=[inserts[0][:2] + (0.25,)],
                     deletes=[(int(src[0]), int(dst[0]))])
        assert sess.apply_mutations(**edits) == ref.apply_mutations(**edits)
        _assert_same_store(sess.store, ref.store)
        _assert_same_run(sess.run("sssp", source=0),
                         ref.run("sssp", source=0))


@pytest.mark.parametrize("val_dtype", ["int8", "float16"])
def test_quantized_merged_shards_match_reference(tmp_path, val_dtype):
    """A dirty shard of a quantized store is quantized again, with new
    (scale, zero): the port's bytes are the reference's."""
    src, dst, w = _random_edges(41)
    g = tmp_path / "q"
    el = tmp_path / "el_q"
    from repro.graph.preprocess import preprocess_graph
    from repro.graph.storage import write_edge_list
    write_edge_list(el, [(src, dst)], weighted=True)
    np.save(el / "weights_00000.npy", w)
    preprocess_graph(el, g, threshold_edge_num=512, ell_max_width=64,
                     num_vertices=N, val_dtype=val_dtype)
    ref = RefDeltaStore(RefGraphStore(g))
    port = DeltaGraphStore(GraphStore(g))
    batches = [dict(inserts=_fresh_inserts(41, src, dst, count=30)),
               dict(updates=[(int(src[3]), int(dst[3]), 7.5)],
                    deletes=[(int(src[5]), int(dst[5]))])]
    for batch in batches:
        assert port.apply(**batch) == ref.apply(**batch)
        _assert_same_store(port, ref)
    for p in port.dirty_shards():
        a, b = port.read_shard(p), ref.read_shard(p)
        assert a.vals.dtype == np.dtype(val_dtype)
        assert (a.val_scale, a.val_zero) == (b.val_scale, b.val_zero)
    with RefSession(ref) as rs, GraphSession(port, device="cpu") as ps:
        want = rs.run("sssp", source=0).values
        got = ps.run("sssp", source=0).values
    # quantized min_plus: XLA may contract the dequantize multiply with the
    # add, so the reference is held to 1 ulp (ROADMAP C2)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_array_max_ulp(got[fin], want[fin], maxulp=1)


def test_epoch_log_matches_reference(tmp_path, monkeypatch):
    src, dst, w = _random_edges(3, n=64, m=300)
    g = _preprocess(tmp_path, "mono", src, dst, w, n=64, threshold=128,
                    width=32)
    # a short log, so that the truncation path runs too (the same cap on
    # both sides)
    for mod in (jdelta, tdelta):
        monkeypatch.setattr(mod, "_EPOCH_LOG_CAP", 3)
    ref, port = RefDeltaStore(RefGraphStore(g)), DeltaGraphStore(GraphStore(g))
    ins = _fresh_inserts(3, src, dst, n=64, count=6)
    s0, d0, w0 = ins[0]
    batches = [dict(inserts=ins[:4]),
               dict(updates=[(s0, d0, w0 / 2)]),              # monotone
               dict(updates=[(s0, d0, w0 * 10)]),             # increase
               dict(deletes=[(int(src[1]), int(dst[1]))]),    # delete
               dict(inserts=ins[4:]),
               dict(deletes=[(99 % 64, 98 % 64)])]            # absent edge
    for batch in batches:
        assert port.apply(**batch) == ref.apply(**batch)
        _assert_same_store(port, ref)
    for e in range(-1, port.epoch() + 2):
        a, b = port.affected_sources_since(e), ref.affected_sources_since(e)
        assert (a is None) == (b is None), e
        if a is not None:
            np.testing.assert_array_equal(a, b)
        assert port.monotone_since(e) == ref.monotone_since(e), e


def test_n_pad_grows_when_a_merged_shard_wraps(graphs):
    """Edges from every vertex into 40 destinations of the shard with the
    most ELL rows wrap each of them over 3 rows (width 128): the shard grows
    from 128 to 192 rows, past every other, so ``n_pad`` must grow before
    the next sweep."""
    base, _, (src, dst, _w), _ = graphs
    ref, sess = _sessions(base, mutable=True, selective_threshold=THRESH)
    with ref, sess:
        before = sess.run("sssp", source=0)
        ref_before = ref.run("sssp", source=0)
        n_pad0 = sess.n_pad
        p = int(np.argmax([m["rows"] for m in sess.store.properties["shards"]]))
        lo = int(sess.store.intervals[p])
        have = set(zip(src.tolist(), dst.tolist()))
        new = [(u, t, 0.5) for t in range(lo, lo + 40) for u in range(N)
               if u != t and (u, t) not in have]
        for s in (sess, ref):
            s.apply_mutations(inserts=new)
        assert sess.n_pad > n_pad0 and sess.n_pad == ref.n_pad
        _assert_same_store(sess.store, ref.store)
        for app, kw in EXACT_APPS:
            _assert_same_run(sess.run(app, **kw), ref.run(app, **kw))
        inc = sess.run_incremental("sssp", source=0, prev=before)
        _assert_same_run(inc, ref.run_incremental("sssp", source=0,
                                                  prev=ref_before))
        np.testing.assert_array_equal(inc.values,
                                      sess.run("sssp", source=0).values)


# ---------------------------------------------------------------------------
# incremental recompute
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("app,kw", EXACT_APPS, ids=[a for a, _ in EXACT_APPS])
def test_incremental_matches_reference_and_cold(graphs, app, kw):
    base, _, _, inserts = graphs
    # cache off: the per-iteration disk bytes then count every shard fetch
    ref, sess = _sessions(base, mutable=True, selective_threshold=THRESH,
                          cache_budget_bytes=0)
    with ref, sess:
        prev, ref_prev = sess.run(app, **kw), ref.run(app, **kw)
        _assert_same_run(prev, ref_prev)
        sess.apply_mutations(inserts=inserts)
        ref.apply_mutations(inserts=inserts)
        inc = sess.run_incremental(app, prev=prev, **kw)
        _assert_same_run(inc, ref.run_incremental(app, prev=ref_prev, **kw))
        cold = sess.run(app, **kw)
    np.testing.assert_array_equal(inc.values, cold.values)
    assert inc.iterations < cold.iterations
    assert sum(h.shards_processed for h in inc.history) < \
        sum(h.shards_processed for h in cold.history)
    assert inc.epoch == cold.epoch == 1


def _scenario(sess, kind, src, dst, inserts):
    """Drive one run_incremental fallback (or guard) on ``sess``; returns
    ``(incremental result, cold result)``."""
    app, kw = ("pagerank", {"max_iters": 10}) if kind == "non_incremental" \
        else ("sssp", {"source": 0})
    prev = sess.run(app, **(dict(kw, max_iters=2) if kind == "unconverged"
                            else kw))
    if kind == "unchanged":
        return sess.run_incremental(app, prev=prev, **kw), prev
    if kind == "delete":
        sess.apply_mutations(inserts=inserts,
                             deletes=[(int(src[0]), int(dst[0]))])
    elif kind == "weight_increase":
        # raise the weight of an edge that exists
        sess.apply_mutations(updates=[(int(src[0]), int(dst[0]), 9.0)])
    elif kind == "log_truncated":
        for i in range(4):  # past the cap of 2 the test sets
            sess.apply_mutations(inserts=inserts[i:i + 1])
    else:
        sess.apply_mutations(inserts=inserts)
    return sess.run_incremental(app, prev=prev, **kw), sess.run(app, **kw)


@pytest.mark.parametrize("kind", ["unchanged", "delete", "weight_increase",
                                  "unconverged", "non_incremental",
                                  "log_truncated"])
def test_incremental_fallbacks_match_reference(graphs, kind, monkeypatch):
    base, _, (src, dst, _w), inserts = graphs
    for mod in (jdelta, tdelta):
        monkeypatch.setattr(mod, "_EPOCH_LOG_CAP", 2)
    ref, sess = _sessions(base, mutable=True, selective_threshold=THRESH)
    with ref, sess:
        inc, cold = _scenario(sess, kind, src, dst, inserts)
        ref_inc, ref_cold = _scenario(ref, kind, src, dst, inserts)
    if kind == "non_incremental":
        np.testing.assert_allclose(inc.values, ref_inc.values, rtol=PR_RTOL)
        np.testing.assert_allclose(inc.values, cold.values, rtol=PR_RTOL)
        assert inc.iterations == ref_inc.iterations == cold.iterations
        return
    _assert_same_run(inc, ref_inc)
    np.testing.assert_array_equal(inc.values, cold.values)
    if kind == "unchanged":
        assert inc.iterations == 0 and inc.converged and inc.history == []
    else:
        # every fallback is a cold run: the same sweeps as one
        assert inc.iterations == cold.iterations
        _assert_same_run(cold, ref_cold)


@pytest.mark.parametrize("cls,kw", [(RefSession, {}),
                                    (GraphSession, {"device": "cpu"})],
                         ids=["reference", "port"])
def test_incremental_guards(graphs, cls, kw):
    base, _, _, _ = graphs
    with cls(base, mutable=True, **kw) as sess:
        prev = sess.run("sssp", source=0)
        with pytest.raises(ValueError, match="incremental recompute"):
            sess.run_incremental("sssp", source=1, prev=prev)
        with pytest.raises(TypeError, match="single-frontier"):
            sess.run_incremental("sssp_multi", sources=(0, 1), prev=prev)
    with cls(base, **kw) as frozen:
        with pytest.raises(TypeError, match="mutable=True"):
            frozen.apply_mutations(inserts=[(0, 1)])


# ---------------------------------------------------------------------------
# epoch pinning: a commit cannot tear a running sweep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("depth", [0, 2])
def test_mid_run_mutation_raises(graphs, depth):
    base, _, (src, dst, _w), _ = graphs
    edit = _fresh_inserts(31, src, dst, count=1)
    with GraphSession(base, mutable=True, prefetch_depth=depth,
                      device="cpu") as sess, \
            RefSession(base, mutable=True) as ref:
        gen = sess.iter_run("pagerank", max_iters=10)
        next(gen)  # mid-flight, epoch pinned at 0
        sess.store.apply(inserts=edit)
        with pytest.raises(ConcurrentMutationError, match="mid-run"):
            for _ in gen:
                pass
        # the next run re-syncs to the new epoch and completes
        res = sess.run("pagerank", max_iters=5)
        assert res.epoch == 1
        ref.apply_mutations(inserts=edit)
        np.testing.assert_allclose(
            res.values, ref.run("pagerank", max_iters=5).values, rtol=PR_RTOL)


# ---------------------------------------------------------------------------
# compaction and the overlay budget
# ---------------------------------------------------------------------------
def _tree_bytes(d: Path) -> dict:
    return {f.name: f.read_bytes() for f in sorted(d.iterdir()) if f.is_file()}


@pytest.mark.parametrize("backend", ["npz", "packed", "memory"])
def test_compaction_matches_reference(graphs, backend, tmp_path):
    base, merged, (src, dst, _w), inserts = graphs
    mine, theirs = tmp_path / "port", tmp_path / "ref"
    for d in (mine, theirs):
        shutil.copytree(base, d)
    edits = dict(inserts=inserts, deletes=[(int(src[2]), int(dst[2]))])
    with GraphSession(mine, backend=backend, mutable=True, device="cpu",
                      selective_threshold=THRESH) as sess, \
            RefSession(theirs, backend=backend, mutable=True,
                       selective_threshold=THRESH) as ref:
        sess.apply_mutations(**edits)
        ref.apply_mutations(**edits)
        want = {app: ref.run(app, **kw).values for app, kw in EXACT_APPS}
        dirty = sess.store.dirty_shards()
        rep, ref_rep = compact(sess.store), ref_compact(ref.store)
        for field in ("epoch", "backend", "shards_rewritten",
                      "bytes_written", "dead_bytes"):
            assert getattr(rep, field) == getattr(ref_rep, field), field
        assert rep.shards_rewritten == tuple(dirty)
        assert sess.store.dirty_shards() == [] and sess.store.epoch() == 1
        if backend == "memory":
            _assert_same_store(sess.store.base, ref.store.base)
        for app, kw in EXACT_APPS:
            np.testing.assert_array_equal(sess.run(app, **kw).values,
                                          want[app])
        assert compact(sess.store).shards_rewritten == ()
    if backend == "memory":
        return
    # the rewritten base: the reference's bytes, file for file
    assert _tree_bytes(mine) == _tree_bytes(theirs)
    with GraphSession(mine, backend=backend, device="cpu",
                      selective_threshold=THRESH) as reopened:
        for app, kw in EXACT_APPS:
            np.testing.assert_array_equal(reopened.run(app, **kw).values,
                                          want[app])


def test_delta_budget_and_env_knobs(graphs, tmp_path, monkeypatch):
    base, _, (src, dst, _w), _ = graphs
    ins = _fresh_inserts(9, src, dst, count=4)
    for name, err in (("port", DeltaBudgetError), ("ref", RefBudgetError)):
        priv = tmp_path / name
        shutil.copytree(base, priv)
        cls = (DeltaGraphStore, GraphStore) if name == "port" else \
            (RefDeltaStore, RefGraphStore)
        store = cls[0](cls[1](priv), delta_budget_bytes=1, auto_compact=True)
        store.apply(inserts=ins[:2])
        assert store.dirty_shards() == [] and store.epoch() == 1
        frozen = cls[0](cls[1](priv), delta_budget_bytes=1,
                        auto_compact=False)
        with pytest.raises(err, match="GRAPHMP_DELTA_BUDGET"):
            frozen.apply(inserts=ins[2:])
    # the same knobs, by the same names, in both packages
    monkeypatch.setenv("GRAPHMP_DELTA_BUDGET", "12345")
    monkeypatch.setenv("GRAPHMP_DELTA_AUTOCOMPACT", "0")
    a = DeltaGraphStore(GraphStore(base))
    b = RefDeltaStore(RefGraphStore(base))
    assert (a.delta_budget_bytes, a.auto_compact) == \
        (b.delta_budget_bytes, b.auto_compact) == (12345, False)


# ---------------------------------------------------------------------------
# serving: memo keyed by epoch, apply_mutations drains and refreshes
# ---------------------------------------------------------------------------
def test_service_memo_refresh_matches_reference(graphs):
    base, _, _, inserts = graphs
    reports = {}
    ref, sess = _sessions(base, mutable=True, selective_threshold=THRESH)
    with ref, sess:
        for name, s in (("ref", ref), ("port", sess)):
            with s.service(max_batch=4, max_wait_ms=1.0) as svc:
                for v in (0, 1, 2, 3):
                    svc.submit("sssp", source=v).result()
                svc.submit("cc").result()
                svc.submit("pagerank").result()
                assert len(svc._memo) == 6
                rep = svc.apply_mutations(inserts=inserts)
                reports[name] = (rep.epoch, rep.memo_refreshed,
                                 rep.memo_dropped)
                hits = svc.stats.snapshot()["memo_hits"]
                got = svc.submit("sssp", source=2).result().values
                assert svc.stats.snapshot()["memo_hits"] == hits + 1
                np.testing.assert_array_equal(
                    got, s.run("sssp", source=2).values)
        np.testing.assert_array_equal(sess.run("sssp", source=2).values,
                                      ref.run("sssp", source=2).values)
    assert reports["port"] == reports["ref"] == (1, 5, 1)


def test_service_mutation_under_concurrent_traffic(graphs):
    base, merged, _, inserts = graphs
    with GraphSession(base, mutable=True, selective_threshold=THRESH,
                      device="cpu") as sess, \
            sess.service(max_batch=4, max_wait_ms=0.5) as svc:
        errors, stop = [], threading.Event()

        def hammer():
            i = 0
            while not stop.is_set():
                try:
                    svc.submit("sssp", source=i % 8).result(timeout=60)
                except Exception as exc:  # noqa: BLE001 - asserted below
                    errors.append(exc)
                i += 1

        threads = [threading.Thread(target=hammer) for _ in range(3)]
        for t in threads:
            t.start()
        try:
            for i in range(0, len(inserts), 10):
                svc.apply_mutations(inserts=inserts[i:i + 10])
        finally:
            stop.set()
            for t in threads:
                t.join()
        assert not errors
        got = {s: svc.submit("sssp", source=s).result().values
               for s in range(8)}
    assert sess.store.epoch() == 5
    with RefSession(merged, selective_threshold=THRESH) as ref:
        for s, values in got.items():
            np.testing.assert_array_equal(values,
                                          ref.run("sssp", source=s).values)


# ---------------------------------------------------------------------------
# property test: both packages' overlays == a brute-force dict model
# ---------------------------------------------------------------------------
_HN = 48


def _store_edge_dict(store):
    out = {}
    for p in range(store.num_shards):
        shard = store.read_shard(p)
        local, s, v = _ell_to_csr_triples(shard)
        for li, si, vi in zip(local + shard.start_vertex, s, v):
            out[(int(si), int(li))] = float(np.float32(vi))
    return out


@pytest.fixture(scope="module")
def hypo_graph(tmp_path_factory):
    src, dst, w = _random_edges(17, n=_HN, m=160)
    g = _preprocess(tmp_path_factory.mktemp("hypo"), "h", src, dst, w,
                    n=_HN, threshold=64, width=16)
    return g, (src, dst, w)


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=25, deadline=None)
@given(st.data())
def test_apply_matches_dict_model_and_reference(hypo_graph, data):
    g, (src, dst, w) = hypo_graph
    port = DeltaGraphStore(GraphStore(g))
    ref = RefDeltaStore(RefGraphStore(g))
    model = {(int(s), int(d)): float(np.float32(x))
             for s, d, x in zip(src, dst, w)}
    vertex = st.integers(0, _HN - 1)
    edge = st.tuples(vertex, vertex).filter(lambda e: e[0] != e[1])
    weight = st.floats(0.25, 4.0, width=32)
    for _ in range(data.draw(st.integers(1, 4))):
        ins = data.draw(st.lists(st.tuples(edge, weight), max_size=12))
        dels = data.draw(st.lists(edge, max_size=6))
        batch = dict(inserts=[(s, d, x) for (s, d), x in ins], deletes=dels)
        assert port.apply(**batch) == ref.apply(**batch)
        for (s, d), x in ins:
            model[(s, d)] = float(np.float32(x))
        for s, d in dels:
            model.pop((s, d), None)
        assert _store_edge_dict(port) == model
        assert port.num_edges == len(model)
        _assert_same_store(port, ref)
        in_deg, out_deg = port.read_vertex_info()
        for v in range(_HN):
            assert out_deg[v] == sum(1 for k in model if k[0] == v)
            assert in_deg[v] == sum(1 for k in model if k[1] == v)


# ---------------------------------------------------------------------------
# a mutable multi-lane session: D = 2 lanes track D = 1 and the reference
# ---------------------------------------------------------------------------
# The reference's sharded session needs a jax mesh, so it runs in a
# subprocess with two forced host devices and writes what it saw to a JSON.
_SHARDED_REFERENCE = """
import json, sys
import numpy as np
from repro.session import GraphSession

base, edits_path, out_path = sys.argv[1:4]
edits = [tuple(e) for e in np.load(edits_path).tolist()]
out = {}
with GraphSession(base, num_devices=2, mutable=True, prefetch_depth=2,
                  selective_threshold=%(thresh)r) as s:
    before = s.run("cc")
    prev = s.run("sssp", source=0)
    s.apply_mutations(inserts=edits)
    for name, r in (("cc", s.run_incremental("cc", prev=before)),
                    ("sssp", s.run_incremental("sssp", source=0, prev=prev)),
                    ("bfs", s.run("bfs", source=0))):
        out[name] = dict(values=np.asarray(r.values).tolist(),
                         iterations=r.iterations,
                         lanes=[list(h.device_disk_bytes) for h in r.history])
json.dump(out, open(out_path, "w"))
"""


def test_mutable_two_lanes_track_one_lane_and_reference(graphs, tmp_path):
    base, _, _, inserts = graphs
    edits = np.array([(s, d, w) for s, d, w in inserts])
    np.save(tmp_path / "edits.npy", edits)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(REPO / "src"))
    r = subprocess.run(
        [sys.executable, "-c",
         textwrap.dedent(_SHARDED_REFERENCE % dict(thresh=THRESH)),
         str(base), str(tmp_path / "edits.npy"), str(tmp_path / "ref.json")],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-4000:]}"
    want = json.loads((tmp_path / "ref.json").read_text())
    got = {}
    for D in (1, 2):
        with GraphSession(base, num_devices=D, device=["cpu"] * D,
                          mutable=True, prefetch_depth=2,
                          selective_threshold=THRESH) as s:
            before = s.run("cc")
            prev = s.run("sssp", source=0)
            s.apply_mutations(inserts=[tuple(e) for e in edits.tolist()])
            got[D] = {"cc": s.run_incremental("cc", prev=before),
                      "sssp": s.run_incremental("sssp", source=0, prev=prev),
                      "bfs": s.run("bfs", source=0)}
    for app, res in got[2].items():
        np.testing.assert_array_equal(res.values, got[1][app].values)
        np.testing.assert_array_equal(res.values,
                                      np.asarray(want[app]["values"],
                                                 dtype=np.float32))
        assert res.iterations == got[1][app].iterations == \
            want[app]["iterations"]
        # per-lane disk bytes: the engines built after the commit assign
        # shards on the new nnz exactly as the reference's do
        assert [list(h.device_disk_bytes) for h in res.history] == \
            want[app]["lanes"]
