"""End-to-end driver (the paper's kind of workload): out-of-core analytics on
a graph bigger than the configured cache, PR + SSSP + CC served by ONE
GraphSession from one preprocessing pass, with fault injection + resume.

    PYTHONPATH=src python -m repro_torch.examples.graph_analytics \
        [--scale 18] [--device cpu]

At --scale 18 this is ~4M edges through real disk shards; scale up if you
have the time/disk.  Demonstrates:
  * one preprocessing, one session, three applications sharing the
    compressed cache (paper §2.2) — watch the per-app disk-byte deltas;
  * the packed single-file backend (zero-copy mmap'd shard views) with the
    async shard pipeline (``prefetch_depth=2``) overlapping disk +
    decompression + staging with the SpMV — watch ``stall`` stay near zero;
  * cache-mode auto-selection under a deliberately tight budget;
  * live iteration monitoring via ``session.iter_run`` (Bloom-filter
    selective scheduling kicking in as SSSP converges);
  * checkpoint + resume mid-PageRank (fault tolerance) through the session.

Runs on the GPU unless ``--device cpu`` is given; without a GPU it raises.
``main`` returns the runs: ``pagerank``, ``sssp`` and ``cc``, ``bfs`` (the
``IterationStats`` that ``iter_run`` yielded), ``full`` and ``resumed``
(the uninterrupted and the resumed PageRank) and ``checkpointed`` (the run
that wrote the checkpoint).
"""
import argparse
import tempfile
import time

import numpy as np

from repro_torch import (GraphSession, materialize, preprocess_graph,
                         rmat_edges, write_edge_list)
from repro_torch.core.engine import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=17)
    ap.add_argument("--edge-factor", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {}
    with tempfile.TemporaryDirectory() as td:
        t0 = time.time()
        src, dst = materialize(rmat_edges(scale=args.scale,
                                          edge_factor=args.edge_factor, seed=1))
        write_edge_list(f"{td}/edges", [(src, dst)])
        store = preprocess_graph(f"{td}/edges", f"{td}/graph",
                                 threshold_edge_num=1 << 17)
        print(f"preprocessed {store.num_edges} edges -> {store.num_shards} "
              f"shards in {time.time()-t0:.1f}s "
              f"(io: {store.io.read/1e6:.0f}MB read, "
              f"{store.io.written/1e6:.0f}MB written)")

        budget = int(store.total_shard_bytes() * 0.4)  # graph > cache
        # packed backend: auto-packs graph/ into one mmap'd file on first use;
        # prefetch_depth=2 streams shards through the async pipeline
        with GraphSession(f"{td}/graph", backend="packed",
                          cache_mode="auto", cache_budget_bytes=budget,
                          prefetch_depth=2, device=device) as session:
            print(f"session: {session!r}")
            last_disk = 0
            for name, kwargs, iters in (("pagerank", {}, 30),
                                        ("sssp", {"source": 0}, 100),
                                        ("cc", {}, 100)):
                res = session.run(name, max_iters=iters, **kwargs)
                out[name] = res
                st = session.stats
                skipped = sum(h.shards_skipped for h in res.history)
                stall = sum(h.stall_seconds for h in res.history)
                print(f"{name:9s} iters={res.iterations:3d} "
                      f"time={res.total_seconds:6.2f}s "
                      f"mode={session.cache.mode} "
                      f"hit={st.hit_ratio:.2f} skipped_shards={skipped} "
                      f"disk_delta={(st.disk_bytes - last_disk)/1e6:.0f}MB "
                      f"stall={stall:.2f}s "
                      f"rate={res.edges_per_second()/1e6:.1f}M edges/s")
                last_disk = st.disk_bytes

            # live monitoring: stream IterationStats as BFS converges
            print("bfs       live:", end=" ")
            out["bfs"] = []
            for it in session.iter_run("bfs", source=0, max_iters=100):
                out["bfs"].append(it)
                if it.iteration % 5 == 0:
                    print(f"[{it.iteration}] active={it.active_ratio:.4f}"
                          f"{'*' if it.selective_enabled else ''}", end=" ")
            print()

        # fault tolerance: checkpoint PR at iteration 10, resume, same answer
        with GraphSession(store, device=device) as s:
            out["full"] = s.run("pagerank", max_iters=20)
        with GraphSession(store, device=device) as s:
            out["checkpointed"] = s.run(
                "pagerank", max_iters=10, checkpoint_dir=f"{td}/ck",
                checkpoint_every=10)
        with GraphSession(store, device=device) as s:
            out["resumed"] = s.run("pagerank", max_iters=20,
                                   checkpoint_dir=f"{td}/ck", resume=True)
        err = float(np.abs(out["resumed"].values - out["full"].values).max())
        print(f"resume-after-'failure' max deviation vs uninterrupted: {err:.2e}")
        assert err < 1e-6
    return out


if __name__ == "__main__":
    main()
