"""Quickstart: GraphMP in five lines of API.

    generate -> preprocess -> GraphSession -> session.run(...) -> stats

A ``GraphSession`` is the unified entry point: it owns the on-disk shard
store, ONE compressed edge cache shared by every application, and the
device-resident vertex arrays — so running PageRank, then SSSP, then CC
pays the disk read once (the paper's "preprocess once, serve many
applications" economics, §2.2/§2.4.2).  Under the hood each run is the VSW
engine: all vertices device-resident, edges streamed shard-by-shard through
the cache, inactive shards Bloom-skipped.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Runs on the GPU unless ``--device cpu`` is given; without a GPU it raises.
``main`` returns the runs: ``pagerank``, ``sssp`` and ``cc`` (``RunResult``)
and ``batch`` (the ``BatchRunResult`` of the landmark SSSPs).
"""
import argparse
import tempfile

import numpy as np

from repro_torch import (GraphSession, materialize, preprocess_graph,
                         rmat_edges, write_edge_list)
from repro_torch.core.engine import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as td:
        print("1) generate a 2^14-vertex, ~260k-edge RMAT graph")
        src, dst = materialize(rmat_edges(scale=14, edge_factor=16, seed=0))
        write_edge_list(f"{td}/edges", [(src, dst)])

        print("2) preprocess: degree scan -> Algorithm-1 intervals -> ELL shards")
        store = preprocess_graph(f"{td}/edges", f"{td}/graph",
                                 threshold_edge_num=1 << 15)
        print(f"   {store.num_shards} shards, {store.num_edges} edges, "
              f"{store.num_vertices} vertices")

        print("3) one session, three applications, one shared cache")
        # prefetch_depth=1: double-buffer shard fetch/staging behind the SpMV
        with GraphSession(f"{td}/graph", cache_mode=1,
                          cache_budget_bytes=1 << 28,
                          prefetch_depth=1, device=device) as session:
            result = session.run("pagerank", max_iters=30)
            top = np.argsort(result.values)[-5:][::-1]
            print(f"   pagerank: {result.iterations} iterations, "
                  f"{result.total_seconds:.2f}s, "
                  f"{result.edges_per_second()/1e6:.1f}M edges/s")
            print(f"   top-5 vertices by rank: {top.tolist()}")
            disk_after_pr = session.stats.disk_bytes

            dist = session.run("sssp", source=int(top[0]), max_iters=100)
            comp = session.run("cc", max_iters=100)
            print(f"   sssp reached {int(np.isfinite(dist.values).sum())} "
                  f"vertices; cc found {len(np.unique(comp.values))} components")
            print(f"   disk bytes: {disk_after_pr/1e6:.1f}MB for pagerank, "
                  f"+{(session.stats.disk_bytes - disk_after_pr)/1e6:.2f}MB "
                  f"for sssp+cc (warm cache), "
                  f"hit ratio {session.stats.hit_ratio:.2f}")

            print("4) batched multi-source: 8 landmark SSSPs, ONE edge sweep")
            disk_before = session.stats.disk_bytes
            landmarks = top.tolist() + [0, 1, 2]
            batch = session.run_batch("sssp", sources=landmarks,
                                      max_iters=100)
            reached = [int(np.isfinite(r.values).sum()) for r in batch]
            print(f"   {len(batch)} frontiers, per-landmark iterations "
                  f"{[r.iterations for r in batch]}, reached {reached}")
            print(f"   extra disk for all {len(batch)} queries: "
                  f"{(session.stats.disk_bytes - disk_before)/1e6:.2f}MB")
            return {"pagerank": result, "sssp": dist, "cc": comp,
                    "batch": session.last_batch_result}


if __name__ == "__main__":
    main()
