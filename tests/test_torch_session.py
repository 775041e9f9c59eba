"""The port's ``GraphSession`` (on the CPU) held against the reference
package's on the conftest RMAT store (scale 9), for pagerank/sssp/bfs/cc
under cache mode {0, adaptive} x prefetch depth {0, 2}.

* BFS/SSSP/CC: values bitwise (min over the same float32 values is exact in
  any order) and every per-iteration ``IterationStats`` field except the
  seconds fields, exactly: both packages read the same shard bytes through
  the same cache and schedule.
* PageRank: a fixed ``max_iters`` and a tiny ``tol`` keep every vertex
  active in both, so both run the same iterations; values are compared with
  ``rtol=PR_RTOL`` because float sums are taken in another order (ROADMAP
  hazard C3).  Per iteration a value sums at most 2·W = 512 float32 terms,
  a relative difference of at most 512·2^-24 ≈ 3.1e-5, and the damped
  iteration (factor 0.85) lets differences accumulate to at most
  1/(1 - 0.85) ≈ 6.7 times that: 2.1e-4.
"""
import dataclasses

import numpy as np
import pytest

from repro.session import GraphSession as RefSession
from repro_torch.session import GraphSession

PR_RTOL = 2.1e-4
EXACT_FIELDS = ("iteration", "active_ratio", "shards_processed",
                "shards_skipped", "disk_bytes", "cache_hit_ratio",
                "selective_enabled", "edges_processed")
RUNS = {
    "pagerank": dict(max_iters=12, tol=1e-9),
    "sssp": dict(source=0),
    "bfs": dict(source=3),
    "cc": {},
}


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("cache_mode", [0, "auto"])
@pytest.mark.parametrize("app", list(RUNS))
def test_port_matches_reference(graph_store, app, cache_mode, prefetch):
    kw = dict(cache_mode=cache_mode, prefetch_depth=prefetch,
              cache_budget_bytes=1 << 20)
    with RefSession(str(graph_store.path), **kw) as s:
        want = s.run(app, **RUNS[app])
    with GraphSession(str(graph_store.path), device="cpu", **kw) as s:
        got = s.run(app, **RUNS[app])
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    assert got.tag == want.tag
    assert got.values.dtype == np.float32 and got.values.shape == want.values.shape
    if app == "pagerank":
        np.testing.assert_allclose(got.values, want.values, rtol=PR_RTOL)
        return
    np.testing.assert_array_equal(got.values, want.values)
    for g, w in zip(got.history, want.history):
        for field in EXACT_FIELDS:
            assert getattr(g, field) == getattr(w, field), field


def test_run_many_iter_run_and_shared_cache(graph_store):
    """run_many shares one cache (the second sweep of the store reads no
    disk), iter_run streams the same iterations run returns, and one engine
    serves every sssp/bfs source."""
    with GraphSession(str(graph_store.path), device="cpu",
                      cache_mode=1, cache_budget_bytes=1 << 24) as s:
        cc, sssp = s.run_many(["cc", ("sssp", dict(source=5))])
        assert cc.history[0].disk_bytes > 0
        assert sum(h.disk_bytes for h in sssp.history) == 0
        gen = s.iter_run("bfs", source=5)
        streamed = []
        while True:
            try:
                streamed.append(next(gen))
            except StopIteration as stop:
                result = stop.value
                break
        assert [dataclasses.asdict(h)["iteration"] for h in streamed] == \
            list(range(result.iterations))
        np.testing.assert_array_equal(result.values, sssp.values)
        assert s.engine("bfs") is s.engine("sssp", source=9)
        assert s.cache_report()["hits"] > 0 and s.stats.hit_ratio > 0
        assert s.warm() == s.cache.cached_bytes


def test_fused_gather_switch_gives_identical_values(graph_store):
    """On the CPU both settings take the plain version; the switch must not
    change a result or the stats."""
    with GraphSession(str(graph_store.path), device="cpu") as s:
        a = s.run("sssp", source=1)
        b = s.run("sssp", source=1,
                  config=s.config.replace(fused_gather=False))
    np.testing.assert_array_equal(a.values, b.values)
    assert a.iterations == b.iterations
