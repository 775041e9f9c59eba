"""The port's app zoo on the CPU, held against the reference package.

Label propagation, k-core, triangle counting and random walks
(``label_propagation``, ``lp_multi``, ``kcore``, ``kcore_multi``,
``triangles_multi`` and the host drivers ``triangles`` and
``random_walks``) run through both packages on the same stores, with the
invocation tables of ``tests/_zoo_runner.py``.  Every zoo value is an
integer below 2^24 (labels, alive flags, common-neighbour and visit counts),
so values, every non-seconds ``IterationStats`` field and the per-column
iteration counts must be bitwise equal; the rest of the registry rides
along under the rules of ``test_torch_session.py`` (PageRank and PPR:
values to ``PR_RTOL`` at a fixed iteration count).

The matrix runs the whole registry over backend {npz, packed, memory} x
cache mode {0, adaptive} x prefetch {0, 2} against the reference's npz run
at depth 0 (the reference's own matrix, ``tests/test_app_zoo.py``, shows
those equal), plus a two-lane leg on ``device=["cpu"] * 2`` against the
reference's sharded session in a subprocess with two forced host devices.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

from repro.core.apps import list_apps as ref_list_apps
from repro.session import GraphSession as RefSession
from repro_torch.core.apps import get_app, list_apps
from repro_torch.session import GraphSession
from tests._zoo_runner import BATCH_ARGS, SOLO_ARGS, run_zoo
from tests.test_app_zoo import N, _build_store, _symmetric_graph
from tests.test_torch_session import EXACT_FIELDS

REPO = Path(__file__).resolve().parents[1]
PR_RTOL = 5e-4  # test_torch_session.py's PageRank tolerance
# plus semirings over float values: held on values only (ROADMAP §C, 3)
FLOAT_APPS = ("pagerank", "personalized_pagerank")
ZOO = ("label_propagation", "lp_multi", "kcore", "kcore_multi",
       "triangles_multi", "triangles", "random_walks")
LANE_FIELDS = EXACT_FIELDS + ("device_disk_bytes",)


def collect_zoo(session_cls, apps, path, fields=EXACT_FIELDS,
                **session_kwargs):
    """name -> (values, iterations, converged, per-iteration ``fields``,
    column_iterations or None) for every non-alias name of ``apps`` (a
    ``list_apps()`` result), invoked as ``tests/_zoo_runner.run_zoo``
    invokes it."""
    out = {}
    with session_cls(path, **session_kwargs) as sess:
        for info in apps:
            if info.kind == "alias":
                continue
            if info.name in BATCH_ARGS:
                kw = dict(BATCH_ARGS[info.name])
                sess.run_batch(info.name, max_iters=kw.pop("max_iters", 400),
                               **kw)
                res = sess.last_batch_result
            else:
                kw = dict(SOLO_ARGS[info.name])
                res = sess.run(info.name, max_iters=kw.pop("max_iters", 400),
                               **kw)
            cols = getattr(res, "column_iterations", None)
            out[info.name] = (
                np.asarray(res.values), res.iterations, res.converged,
                [tuple(getattr(h, f) for f in fields) for h in res.history],
                None if cols is None else np.asarray(cols))
    return out


def assert_zoo_equal(got, want, where=""):
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        msg = f"{name}{where}"
        assert g[1] == w[1], f"{msg}: {g[1]} iterations, reference {w[1]}"
        if name in FLOAT_APPS:
            np.testing.assert_allclose(g[0], w[0], rtol=PR_RTOL, err_msg=msg)
            continue
        np.testing.assert_array_equal(g[0], w[0], err_msg=msg)
        assert g[0].dtype == w[0].dtype, msg
        assert g[2] == w[2], f"{msg}: converged {g[2]}, reference {w[2]}"
        assert g[3] == w[3], f"{msg}: IterationStats differ"
        if w[4] is not None:
            np.testing.assert_array_equal(g[4], w[4], err_msg=msg)


@pytest.fixture(scope="module")
def zoo_graph(tmp_path_factory):
    """The reference's symmetric zoo graph (``tests/test_app_zoo.py``)."""
    src, dst = _symmetric_graph(42, N, 3 * N)
    base = tmp_path_factory.mktemp("torch_zoo")
    store = _build_store(base, src, dst, N)
    assert store.num_shards > 1
    return src, dst, str(base / "store")


@pytest.fixture(scope="module")
def reference(zoo_graph):
    """cache mode -> the reference's zoo at (npz, prefetch 0)."""
    _, _, path = zoo_graph
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = collect_zoo(RefSession, ref_list_apps(), path,
                                      backend="npz", cache_mode=mode,
                                      prefetch_depth=0)
        return cache[mode]

    return get


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def test_list_apps_matches_reference():
    def rows(apps):
        return [(i.name, i.kind, i.incremental, i.family) for i in apps]

    assert rows(list_apps()) == rows(ref_list_apps())
    kinds = {i.name: i.kind for i in list_apps()}
    for name, kind in (("label_propagation", "vertex"), ("kcore", "vertex"),
                       ("lp_multi", "batched"), ("kcore_multi", "batched"),
                       ("triangles_multi", "batched"),
                       ("triangles", "driver"), ("random_walks", "driver"),
                       ("lp", "alias"), ("triangle_count", "alias"),
                       ("random_walk", "alias")):
        assert kinds[name] == kind, name
    fams = {i.name: i.family for i in list_apps()}
    assert fams["kcore"] == "plus_src/kcore_multi"
    assert fams["lp"] == "max_src/lp_multi"
    assert fams["random_walk"] == "walk/random_walks"


@pytest.mark.parametrize("name", ["label_propagation", "lp_multi", "kcore",
                                  "kcore_multi", "triangles_multi"])
def test_program_signatures_match_reference(name):
    """Equal ``jit_signature``s, so engines are shared as the reference
    shares them; the same constants reach ``post``."""
    from repro.core.apps import get_app as ref_get_app
    got, want = get_app(name), ref_get_app(name)
    assert got.jit_signature == want.jit_signature
    assert (got.semiring, got.sources) == (want.semiring, want.sources)
    assert getattr(got, "wants_iteration", False) == \
        getattr(want, "wants_iteration", False)
    if getattr(want, "make_aux", None) is not None:
        np.testing.assert_array_equal(got.make_aux(7), want.make_aux(7))
    for a, b in zip(got.init(7, np.ones(7), np.ones(7)),
                    want.init(7, np.ones(7), np.ones(7))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the differential matrix
# ---------------------------------------------------------------------------
def test_collector_invokes_what_run_zoo_invokes(zoo_graph, reference):
    """The collector's calls are ``run_zoo``'s: same values, same disk
    bytes."""
    _, _, path = zoo_graph
    want = run_zoo(path, backend="npz", cache_mode=0, prefetch_depth=0)
    got = reference(0)
    assert got.keys() == want.keys()
    for name, (vals, disk) in want.items():
        np.testing.assert_array_equal(got[name][0], vals, err_msg=name)
        assert sum(h[EXACT_FIELDS.index("disk_bytes")]
                   for h in got[name][3]) == disk


MATRIX = [pytest.param(b, m, p, id=f"{b}-mode{m}-pf{p}")
          for b in ("npz", "packed", "memory")
          for m in (0, "adaptive")
          for p in (0, 2)]


@pytest.mark.parametrize("backend,cache_mode,prefetch", MATRIX)
def test_zoo_matches_reference(zoo_graph, reference, backend, cache_mode,
                               prefetch):
    _, _, path = zoo_graph
    got = collect_zoo(GraphSession, list_apps(), path, device="cpu",
                      backend=backend, cache_mode=cache_mode,
                      prefetch_depth=prefetch)
    assert_zoo_equal(got, reference(cache_mode),
                     f" under {backend}/mode {cache_mode}/pf{prefetch}")


_SHARDED_REFERENCE = """
import pickle, sys
sys.path[:0] = sys.argv[3:5]
from repro.core.apps import list_apps
from repro.session import GraphSession
from tests.test_torch_zoo import LANE_FIELDS, collect_zoo
out = collect_zoo(GraphSession, list_apps(), sys.argv[1], fields=LANE_FIELDS,
                  num_devices=2, backend="packed", cache_mode="adaptive",
                  prefetch_depth=2)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def test_zoo_two_lanes_matches_reference(zoo_graph, tmp_path):
    """D = 2 lanes (packed, adaptive, prefetch 2: the serving shape): the
    whole registry equal to the reference's sharded session, per-lane disk
    bytes included, and to one lane."""
    _, _, path = zoo_graph
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(_SHARDED_REFERENCE), path,
         str(tmp_path / "ref.pkl"), str(REPO / "src"), str(REPO)],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr[-4000:]}"
    with open(tmp_path / "ref.pkl", "rb") as f:
        want = pickle.load(f)
    kw = dict(backend="packed", cache_mode="adaptive", prefetch_depth=2)
    got = collect_zoo(GraphSession, list_apps(), path, fields=LANE_FIELDS,
                      num_devices=2, device=["cpu"] * 2, **kw)
    assert_zoo_equal(got, want, " at D = 2")
    one = collect_zoo(GraphSession, list_apps(), path, device="cpu", **kw)
    for name in ZOO:
        np.testing.assert_array_equal(got[name][0], one[name][0],
                                      err_msg=name)
        assert got[name][1] == one[name][1], name


# ---------------------------------------------------------------------------
# a directed graph: dead ends, deeper peels, seeded broadcasts that stop
# ---------------------------------------------------------------------------
DIRECTED = [
    ("run", "label_propagation", {}),
    ("run", "kcore", dict(k=1)),
    ("run", "kcore", dict(k=3)),
    ("run", "kcore", dict(k=6)),
    ("run", "triangles", dict(chunk=48, lo=5, hi=150)),
    ("batch", "lp", dict(sources=[0, 3, 77, 300])),
    ("batch", "kcore", dict(sources=[1, 2, 4, 6, 9])),
    ("batch", "triangle_count", dict(sources=[0, 1, 2])),
    ("batch", "random_walk", dict(sources=[0, 3, 77, 300, 450], length=20,
                                  seed=5)),
]


@pytest.mark.parametrize("how,app,kw", DIRECTED,
                         ids=[f"{a}-{i}" for i, (_, a, _) in
                              enumerate(DIRECTED)])
def test_directed_graph_matches_reference(graph_store, how, app, kw):
    """The conftest RMAT store (directed, with dead ends and sources of no
    in-edges): values, stats and per-column iterations bitwise."""
    path = str(graph_store.path)
    results = []
    for cls, extra in ((RefSession, {}), (GraphSession, dict(device="cpu"))):
        with cls(path, **extra) as s:
            if how == "run":
                res = s.run(app, **kw)
                cols = None
            else:
                s.run_batch(app, **kw)
                res = s.last_batch_result
                cols = np.asarray(res.column_iterations)
            results.append((np.asarray(res.values), res.iterations,
                            res.converged,
                            [tuple(getattr(h, f) for f in EXACT_FIELDS)
                             for h in res.history], cols))
    want, got = results
    assert_zoo_equal({app: got}, {app: want})


def test_solo_walk_equals_its_column(graph_store):
    with GraphSession(str(graph_store.path), device="cpu") as s:
        cols = s.run_batch("random_walk", sources=[3, 77, 300], length=16,
                           seed=9)
        for k, v in enumerate((3, 77, 300)):
            solo = s.run_batch("random_walk", sources=[v], length=16,
                               seed=9)[0]
            np.testing.assert_array_equal(cols[k].values, solo.values)
            assert cols[k].iterations == solo.iterations


def test_triangles_share_one_engine(zoo_graph):
    """A padded slab keeps K constant: every chunk runs on one [n, C]
    engine, and the counts equal the reference's."""
    _, _, path = zoo_graph
    with GraphSession(path, device="cpu") as s:
        got = s.run("triangles", chunk=40, lo=3, hi=170)
        keys = [k for k in s._engines if k[0][0] == "sig"]
        assert keys == [(("sig", ("triangles_multi", 40)), s.config)]
    with RefSession(path) as ref:
        want = ref.run("triangles", chunk=40, lo=3, hi=170)
    np.testing.assert_array_equal(got.values, want.values)
    # five chunks of three sweeps: the post is the identity from it >= 2
    assert got.iterations == want.iterations == 5 * 3
    assert got.values[:3].sum() == got.values[170:].sum() == 0


def test_incremental_label_propagation_matches_reference(zoo_graph,
                                                         tmp_path):
    """Labels only grow: after inserts, ``run_incremental`` continues the
    old fixpoint to the cold run's labels, as the reference's does."""
    import shutil
    _, _, path = zoo_graph
    store = tmp_path / "store"
    shutil.copytree(path, store)
    ins = [(5, 190, 1.0), (100, 7, 1.0), (191, 0, 1.0)]
    out = []
    for cls, extra in ((RefSession, {}), (GraphSession, dict(device="cpu"))):
        with cls(str(store), mutable=True, backend="npz", **extra) as s:
            prev = s.run("label_propagation")
            s.apply_mutations(inserts=ins)
            inc = s.run_incremental("label_propagation", prev=prev)
            cold = s.run("label_propagation")
            np.testing.assert_array_equal(inc.values, cold.values)
            assert inc.iterations <= cold.iterations
            out.append((inc.values, inc.iterations,
                        [tuple(getattr(h, f) for f in EXACT_FIELDS)
                         for h in inc.history]))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1:] == out[0][1:]


# ---------------------------------------------------------------------------
# dispatch guards (the reference's, tests/test_app_zoo.py)
# ---------------------------------------------------------------------------
GUARDS = [
    ("run-checkpoint", TypeError, "host-driven",
     lambda s: s.run("random_walks", sources=(1,), checkpoint_dir="/x",
                     checkpoint_every=2)),
    ("iter_run", TypeError, "host-driven",
     lambda s: next(s.iter_run("triangles"))),
    ("engine", TypeError, "host-driven", lambda s: s.engine("triangles")),
    ("run_batch-solo-driver", TypeError, "not a batched application",
     lambda s: s.run_batch("triangles", sources=[1])),
    ("negative-threshold", ValueError, "thresholds",
     lambda s: s.run_batch("kcore", sources=[-1])),
    ("run_incremental-driver", TypeError, "single-frontier",
     lambda s: s.run_incremental("triangles", prev=None)),
    ("run_incremental-batched", TypeError, "single-frontier",
     lambda s: s.run_incremental("lp_multi", prev=None)),
    ("triangles-empty-slab", ValueError, "empty triangle slab",
     lambda s: s.run("triangles", lo=50, hi=50)),
]


@pytest.mark.parametrize("name,exc,match,call", GUARDS,
                         ids=[g[0] for g in GUARDS])
def test_driver_dispatch_guards(zoo_graph, name, exc, match, call):
    _, _, path = zoo_graph
    for cls, extra in ((GraphSession, dict(device="cpu")), (RefSession, {})):
        with cls(path, **extra) as s:
            with pytest.raises(exc, match=match):
                call(s)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------
def test_service_serves_the_whole_registry(zoo_graph):
    _, _, path = zoo_graph
    with GraphSession(path, device="cpu") as sess, sess.service() as svc:
        assert {i.name for i in list_apps()} <= set(svc._served_apps())


SERVED = {
    "lp": ("source", [0, 5, 9, 40, 77], {}),
    "kcore": ("k", [2, 3, 4, 5, 6], {}),
    "triangle_count": ("vertex", [3, 17, 40, 41, 100], {}),
    "random_walk": ("source", [1, 5, 9, 50, 191], dict(length=12, seed=3)),
}


def _ref_solo(ref, app, value, extra):
    """The reference's answer to one query: a solo run for kcore, a K = 1
    run_batch for the batch-only names (their solo form)."""
    if app == "kcore":
        return ref.run("kcore", k=value, max_iters=400)
    return ref.run_batch(app, sources=[value], max_iters=400, **extra)[0]


@pytest.mark.parametrize("app", sorted(SERVED))
def test_coalesced_zoo_answers_equal_solo(zoo_graph, app):
    """Queries from 4 client threads coalesce into batches; every answer
    equals the reference's solo run of that query bitwise, and the port's
    own."""
    _, _, path = zoo_graph
    param, values, extra = SERVED[app]
    answers, errors = {}, []
    with GraphSession(path, device="cpu") as sess:
        with sess.service(max_batch=4, max_wait_ms=50.0,
                          memoize=False) as svc:
            def client(c):
                try:
                    futs = [(v, svc.submit(app, **{param: v}, max_iters=400,
                                           **extra))
                            for i, v in enumerate(values) if i % 4 == c]
                    for v, f in futs:
                        answers[v] = f.result(timeout=120)
                except BaseException as exc:  # noqa: BLE001
                    errors.append(exc)

            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            snap = svc.stats.snapshot()
        assert not errors, errors
        assert sum(k * v for k, v in snap["batch_occupancy"].items()) \
            == len(values)
        own = {v: _ref_solo(sess, app, v, extra) for v in values}
    with RefSession(path) as ref:
        for v in values:
            want = _ref_solo(ref, app, v, extra)
            np.testing.assert_array_equal(answers[v].values, want.values,
                                          err_msg=f"{app} {param}={v}")
            np.testing.assert_array_equal(own[v].values, want.values)
            assert answers[v].iterations == want.iterations
