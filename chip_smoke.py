#!/usr/bin/env python3
"""Drive the PyTorch port of GraphMP on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--scale 22] [--edge-factor 16]

Run from the root of the repository, on a machine with a CUDA GPU and
``nvcc``.  It imports ``repro_torch``, torch and numpy only.  Phases:

1. device  — the card's name and power limit, versions, and the build of the
   SpMV kernels from ``src/repro_torch/kernels/spmv/csrc`` (started in the
   background while phase 2 runs);
2. data    — Graph500 RMAT (a, b, c = .57, .19, .19, seed 0) written as an
   edge list and preprocessed with ``preprocess_graph``'s defaults into a
   temporary directory;
3. kernels — on every shard of the store, both kernels against their plain
   torch versions for all 5 semirings x {float32, float16, int8} edge
   values; then each kernel timed over one sweep of the store (every shard
   once) — its device time from torch.profiler, CUDA-event time beside it —
   next to its byte bound, its plain version and one PyTorch library call
   computing the same function;
4. main path — ``GraphSession(store)`` (device "cuda") runs pagerank, sssp,
   bfs and cc through the fused kernel, through the gather + fold kernel,
   and with ``use_kernel=False``; bfs again at prefetch depth 2.  Exact apps
   must agree bitwise, PageRank to ``PR_RTOL``; each kernel's launch count
   must equal the shards its runs processed.

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero before it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
SEMIS = ("plus_times", "plus_src", "min_plus", "min_src", "max_src")
DTYPES = ("float32", "float16", "int8")
# plus semirings: a row folds <= 512 positive float32 terms in another order
PLUS_RTOL = 3.1e-5
# PageRank: float32 sums in another order per iteration (hub rows wrap over
# many ELL rows, combined by atomics), damped by 1 / (1 - 0.85) over the run
PR_RTOL = 5e-4
CACHE_BUDGET = 16 << 30        # holds the decoded scale-22 store in host RAM
KERNEL_SOURCE = "src/repro_torch/kernels/spmv/csrc/ell_spmv.cu"
REPLACES = {"ell_spmv_fused": "src/repro/kernels/spmv/spmv.py:328",
            "ell_fold": "src/repro/kernels/spmv/spmv.py:172"}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


class Failed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


# --------------------------------------------------------------------------
def phase_data(tmp: Path, scale: int, edge_factor: int):
    from repro_torch.graph.generate import rmat_edges
    from repro_torch.graph.preprocess import preprocess_graph
    from repro_torch.graph.storage import write_edge_list

    t0 = time.perf_counter()
    meta = write_edge_list(tmp / "edges", rmat_edges(
        scale, edge_factor, a=0.57, b=0.19, c=0.19, seed=0))
    t1 = time.perf_counter()
    store = preprocess_graph(str(tmp / "edges"), str(tmp / "store"))
    t2 = time.perf_counter()
    shutil.rmtree(tmp / "edges")
    disk = sum(f.stat().st_size for f in (tmp / "store").iterdir())
    log(f"data: rmat scale={scale} edge_factor={edge_factor} "
        f"|V|={meta['num_vertices']} |E|={meta['num_edges']} "
        f"shards={store.num_shards} generate+write_s={t1 - t0:.1f} "
        f"preprocess_s={t2 - t1:.1f} store_bytes={disk}")
    return store


def _compare(torch, got, want, plus: bool) -> tuple[bool, float]:
    same = (got == want) | (got.isnan() & want.isnan())
    diff = torch.where(same, torch.zeros_like(got), (got - want).abs())
    if plus:
        ok = bool((diff <= PLUS_RTOL * want.abs()).all())
    else:
        ok = bool(same.all())
    return ok, float(diff.max())


def phase_kernels(torch, store, dev):
    """Hold both kernels against their plain versions on every shard, then
    time them over one sweep of the store.  Returns the kernel records."""
    import numpy as np

    from repro_torch.core.shards import quantize_shard
    from repro_torch.kernels.spmv import cuda, ref

    n = store.num_vertices
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand(n, generator=gen, device=dev)
    x_inf = x.clone()  # min/max semirings also see unreached (inf) sources
    x_inf[torch.rand(n, generator=gen, device=dev) < 0.2] = float("inf")
    rng = np.random.default_rng(0)
    err = {"ell_spmv_fused": 0.0, "ell_fold": 0.0}
    resident = []   # per shard: what the timing sweep needs
    checks = 0
    t0 = time.perf_counter()
    for p in range(store.num_shards):
        ell = store.read_shard(p)
        cols = torch.from_numpy(ell.cols).to(dev)
        mask = ell.cols >= 0
        weights = np.where(mask, rng.random(ell.shape, dtype=np.float32) * 9
                           + 0.5, 0).astype(np.float32)
        weighted = dataclasses.replace(ell, vals=weights)
        xg = {False: ref.gather(x, cols), True: ref.gather(x_inf, cols)}
        quantized = {}
        for dtype in DTYPES:
            q = quantize_shard(weighted, dtype)
            vals = torch.from_numpy(q.vals).to(dev)
            qp = (q.val_scale, q.val_zero)
            quantized[dtype] = (vals, qp)
            deq = ref.maybe_dequantize(vals, qp)
            for sem in SEMIS:
                plus = sem.startswith("plus")
                xs = x if plus else x_inf
                g = xg[not plus]
                want = ref.ell_fold_ref(g, deq, cols, sem)
                for name, got in (
                        ("ell_spmv_fused",
                         cuda.ell_spmv_fused(xs, cols, vals, sem, qp)),
                        ("ell_fold", cuda.ell_fold(g, vals, cols, sem, qp))):
                    ok, e = _compare(torch, got, want, plus)
                    err[name] = max(err[name], e)
                    check(ok, f"{name} disagrees with its plain version on "
                              f"shard {p} ({sem}, {dtype}): max abs err {e}")
                    checks += 1
        unit = torch.from_numpy(ell.vals).to(dev)  # the store's own vals
        resident.append(dict(
            cols=cols, unit=unit, xg=xg[False], rows=ell.shape[0],
            slots=ell.shape[0] * ell.shape[1],
            distinct=int(torch.unique(cols[cols >= 0]).numel()),
            float32=(unit, (1.0, 0.0)), float16=quantized["float16"],
            int8=quantized["int8"]))
    torch.cuda.synchronize()
    log(f"kernels: {checks} checks against the plain versions on "
        f"{store.num_shards} shards x {len(SEMIS)} semirings x "
        f"{len(DTYPES)} dtypes passed in {time.perf_counter() - t0:.1f}s; "
        f"max abs err {err}")
    return time_kernels(torch, resident, x, n, err)


def _time_sweep(torch, calls, reps: int = 10) -> tuple[float, float]:
    """``(device_ms, events_ms)`` for one pass over ``calls`` (one launch per
    shard), averaged over ``reps`` passes after two warm-up passes.

    ``device_ms`` sums the durations of the device activities the passes
    ran (kernels, copies, memsets), from torch.profiler: the kernel's own
    time.  ``events_ms`` is CUDA events around the passes, which also counts
    the gaps in which the card waited for the host to launch the next
    kernel — at ~35 us a kernel, the host's launch overhead shows there."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        for c in calls:
            c()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with warnings.catch_warnings():  # "clears events at end of cycle"
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(reps):
                for c in calls:
                    c()
            end.record()
            end.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if str(e.device_type).endswith("CUDA"))
    events_ms = start.elapsed_time(end) / reps
    if device_us <= 0:
        log("timing: torch.profiler saw no device activity; reporting the "
            "CUDA-event time as the device time")
        return events_ms, events_ms
    return device_us / 1e3 / reps, events_ms


def time_kernels(torch, resident, x, n, err):
    from repro_torch.kernels.spmv import cuda, ref

    sem = "plus_src"  # PageRank's semiring, over the store's float32 vals
    fused = [lambda s=s: cuda.ell_spmv_fused(x, s["cols"], s["unit"], sem)
             for s in resident]
    fused_plain = [lambda s=s: ref.ell_fold_ref(ref.gather(x, s["cols"]),
                                                s["unit"], s["cols"], sem)
                   for s in resident]
    fold = [lambda s=s: cuda.ell_fold(s["xg"], s["unit"], s["cols"], sem)
            for s in resident]
    fold_plain = [lambda s=s: ref.ell_fold_ref(s["xg"], s["unit"], s["cols"],
                                               sem) for s in resident]
    # one library call per shard computing the same function: a CSR sparse
    # product (unit values at the valid slots) for the fused kernel, and a
    # row-wise dot product with the unit vals (0 at sentinels) for the fold
    csrs = []
    for s in resident:
        valid = s["cols"] >= 0
        crow = torch.zeros(s["rows"] + 1, dtype=torch.int64, device=x.device)
        crow[1:] = valid.sum(1).cumsum(0)
        # ELL rows hold duplicate, unsorted columns: valid input for a sparse
        # product, though not a canonical CSR, so the invariant check is off
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            csrs.append(torch.sparse_csr_tensor(
                crow, s["cols"][valid].long(), s["unit"][valid],
                size=(s["rows"], n), check_invariants=False))
    xcol = x[:, None]
    lib_fused = [lambda c=c: torch.sparse.mm(c, xcol) for c in csrs]
    lib_fold = [lambda s=s: torch.linalg.vecdot(s["unit"], s["xg"])
                for s in resident]
    # the library calls must compute what the kernels compute
    s0 = resident[0]
    k0 = cuda.ell_spmv_fused(x, s0["cols"], s0["unit"], sem)
    check(torch.allclose(torch.sparse.mm(csrs[0], xcol), k0, rtol=PLUS_RTOL,
                         atol=0), "sparse.mm differs from ell_spmv_fused")
    check(torch.allclose(torch.linalg.vecdot(s0["unit"], s0["xg"])[:, None],
                         k0, rtol=PLUS_RTOL, atol=0),
          "vecdot differs from ell_fold")

    rows = sum(s["rows"] for s in resident)
    slots = sum(s["slots"] for s in resident)
    distinct = sum(s["distinct"] for s in resident)

    def bound_bytes(name: str, val_bytes: int) -> int:
        """Each input read once, the output written once: cols, the edge
        values (``val_bytes`` per slot; the *_src semirings never read
        them), the frontier at this store's distinct sources (fused) or the
        gathered xg (fold), and [R] float32 partials."""
        src = 4 * distinct if name == "ell_spmv_fused" else 4 * slots
        return slots * (4 + val_bytes) + src + 4 * rows

    records = {}
    for name, calls, plain, lib in (
            ("ell_spmv_fused", fused, fused_plain, lib_fused),
            ("ell_fold", fold, fold_plain, lib_fold)):
        # plain, kernel, kernel, plain: compare within one call, in turns
        (p1, p1e), (k1, k1e) = _time_sweep(torch, plain), \
            _time_sweep(torch, calls)
        (k2, k2e), (p2, p2e) = _time_sweep(torch, calls), \
            _time_sweep(torch, plain)
        lib_ms, lib_e = _time_sweep(torch, lib)
        nbytes = bound_bytes(name, 0)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ms = min(k1, k2)
        records[name] = dict(
            name=name, route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES[name], launches=None,
            max_abs_err=err[name], ms=ms, plain_ms=min(p1, p2),
            bound_ms=bound, bound_by="bytes", library_ms=lib_ms)
        log(f"timing: {name} {sem} float32, one sweep = {len(calls)} "
            f"launches, device ms (events ms): kernel {k1:.4f} ({k1e:.4f})"
            f" / {k2:.4f} ({k2e:.4f}), plain {p1:.4f} ({p1e:.4f}) / "
            f"{p2:.4f} ({p2e:.4f}), library {lib_ms:.4f} ({lib_e:.4f}); "
            f"bound {bound:.4f} ms ({nbytes} bytes at 3.35 TB/s); "
            f"{nbytes / ms / 1e9:.2f} TB/s")
    # SSSP/BFS's semiring reads the edge values: the store's float32 unit
    # values, and the float16/int8 ones a weighted store would hold
    sem = "min_plus"
    for dtype, val_bytes in (("float32", 4), ("float16", 2), ("int8", 1)):
        for name in ("ell_spmv_fused", "ell_fold"):
            if name == "ell_spmv_fused":
                calls = [lambda s=s: cuda.ell_spmv_fused(
                    x, s["cols"], s[dtype][0], sem, s[dtype][1])
                    for s in resident]
            else:
                calls = [lambda s=s: cuda.ell_fold(
                    s["xg"], s[dtype][0], s["cols"], sem, s[dtype][1])
                    for s in resident]
            ms, ev = _time_sweep(torch, calls)
            nbytes = bound_bytes(name, val_bytes)
            log(f"timing: {name} {sem} {dtype} vals, one sweep: kernel "
                f"{ms:.4f} ms device ({ev:.4f} events), bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, "
                f"{nbytes / ms / 1e9:.2f} TB/s")
    return records


# --------------------------------------------------------------------------
def phase_main_path(torch, store_path: str):
    """One GraphSession on the card: the four apps through each kernel and
    through the plain version; bfs at prefetch 0 and 2.  Returns the launch
    counts of the run."""
    import numpy as np

    from repro_torch.kernels.spmv import cuda
    from repro_torch.session import GraphSession

    runs = [("pagerank", dict(max_iters=10)), ("sssp", dict(source=0)),
            ("bfs", dict(source=0)), ("cc", {})]
    results = {}
    shards_by_kernel = {"ell_spmv_fused": 0, "ell_fold": 0}
    with GraphSession(store_path, cache_mode=1,
                      cache_budget_bytes=CACHE_BUDGET) as s:
        base = s.config
        variants = {
            "fused": base,
            "gather+fold": base.replace(fused_gather=False),
            "plain": base.replace(use_kernel=False),
            "fused_prefetch2": base.replace(prefetch_depth=2),
        }
        cuda.reset_launches()
        for variant, cfg in variants.items():
            for app, kw in runs:
                if variant == "fused_prefetch2" and app != "bfs":
                    continue
                t0 = time.perf_counter()
                r = s.run(app, config=cfg, **kw)
                wall = time.perf_counter() - t0
                shards = sum(h.shards_processed for h in r.history)
                if cfg.use_kernel is not False:
                    key = ("ell_spmv_fused" if cfg.fused_gather
                           else "ell_fold")
                    shards_by_kernel[key] += shards
                disk = sum(h.disk_bytes for h in r.history)
                hits = np.mean([h.cache_hit_ratio for h in r.history])
                # fetch: cache get + host->device staging; stall: the part
                # of it the sweep waited for (all of it at depth 0)
                fetch = sum(h.fetch_seconds for h in r.history)
                stall = sum(h.stall_seconds for h in r.history)
                log(f"main: {variant:15s} {app:8s} iterations={r.iterations} "
                    f"converged={r.converged} seconds={r.total_seconds:.3f} "
                    f"wall_s={wall:.3f} "
                    f"edges_per_s={r.edges_per_second():.4g} "
                    f"shards={shards} disk_bytes={disk} "
                    f"mean_hit_ratio={hits:.3f} fetch_s={fetch:.3f} "
                    f"stall_s={stall:.3f}")
                check(np.isfinite(r.values).any() and
                      r.values.shape == (s.n,),
                      f"{variant} {app}: bad values")
                results[variant, app] = r
        launches = dict(cuda.launches)
        profile_bfs(torch, s, base, results["fused", "bfs"].values)
    for name, want in shards_by_kernel.items():
        check(launches[name] == want and want > 0,
              f"{name}: {launches[name]} launches on the main path, "
              f"expected one per processed shard ({want})")
    for app, _ in runs:
        ref_r = results["plain", app]
        for variant in ("fused", "gather+fold"):
            r = results[variant, app]
            check(r.iterations == ref_r.iterations,
                  f"{variant} {app}: {r.iterations} iterations, plain "
                  f"{ref_r.iterations}")
            if app == "pagerank":
                rel = np.max(np.abs(r.values - ref_r.values)
                             / np.abs(ref_r.values))
                log(f"main: pagerank {variant} vs plain max rel err {rel:.3e}"
                    f" (rtol {PR_RTOL})")
                check(rel <= PR_RTOL, f"pagerank {variant} off by {rel}")
            else:
                check(np.array_equal(r.values, ref_r.values),
                      f"{app} {variant} differs from the plain run")
    check(np.array_equal(results["fused_prefetch2", "bfs"].values,
                         results["fused", "bfs"].values),
          "bfs at prefetch depth 2 differs from depth 0")
    reached = np.isfinite(results["fused", "bfs"].values).sum()
    log(f"main: all comparisons passed; bfs reached {reached} vertices; "
        f"launches {launches}")
    return launches


def profile_bfs(torch, session, cfg, want) -> None:
    """One more bfs run (warm cache, prefetch depth 0) under torch.profiler:
    the device's busy share of the run's wall time and where device time
    goes.  Its values must equal ``want``; its launches come after the main
    path's counts were read."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():  # "clears events at end of cycle"
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r = session.run("bfs", config=cfg, source=0)
            torch.cuda.synchronize()
    check(np.array_equal(r.values, want),
          "bfs under torch.profiler differs from the main path's bfs")
    device = [(e.self_device_time_total, e.key, e.count)
              for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    # the run's own iteration seconds (the profiler's start-up is outside
    # them, its per-op overhead inside): the share is a lower bound
    busy = sum(d[0] for d in device) / 1e6
    log(f"profile: bfs under torch.profiler seconds={r.total_seconds:.3f} "
        f"device_busy_s={busy:.3f} "
        f"busy_share={busy / r.total_seconds:.3f}")
    for us, key, count in sorted(device, reverse=True)[:6]:
        log(f"profile:   {us / 1e3:10.2f} ms  x{count:<6d} {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--edge-factor", type=int, default=16)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.spmv import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = gpu_name_and_power()
    log(f"device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    build: dict = {}

    def run_build():
        t0 = time.perf_counter()
        try:
            cuda.build()
        except BaseException as exc:  # noqa: BLE001 — reported after join
            build["error"] = exc
        build["seconds"] = time.perf_counter() - t0

    build_thread = threading.Thread(target=run_build, name="nvcc")
    build_thread.start()
    tmp = Path(tempfile.mkdtemp(prefix="graphmp_chip_smoke_"))
    try:
        store = phase_data(tmp, args.scale, args.edge_factor)
        build_thread.join()
        if "error" in build:
            raise build["error"]
        log(f"device: kernels built in {build['seconds']:.1f}s "
            f"({cuda.library_path().name})")
        records = phase_kernels(torch, store, dev)
        torch.cuda.empty_cache()
        launches = phase_main_path(torch, str(store.path))
    finally:
        build_thread.join()
        shutil.rmtree(tmp, ignore_errors=True)
    for name, rec in records.items():
        rec["launches"] = launches[name]
    print(json.dumps({"kernels": list(records.values())}))
    print(gpu_name_and_power())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
