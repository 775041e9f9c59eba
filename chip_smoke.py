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
3. kernels — on every shard of the store, the four ELL kernels against
   their plain torch versions for all 5 semirings x {float32, float16, int8}
   edge values: the single-column ones (K = 1) and the batched ones at
   K = ``BATCH_K`` (16), plus K = 3, 4, 32 and 64 and a K = 16 frontier
   view off 16-byte alignment on the first shards; the same edges cut into
   a 2-D tiling (D = S = 2 destination blocks x source ranges, local cols,
   width 128, with each row's extent built on the card) and
   ``ell_gather_fold`` (B4) held on every tile with and without the
   extents; then each kernel timed over one sweep of the store (every
   shard once; B4: every tile once, with and without extents) — its device
   time from torch.profiler, CUDA-event time beside it — next to its byte
   bound, its plain version and one PyTorch library call computing the
   same function, and the batched kernels at K = 4, 16 and 32;
4. main path — ``GraphSession(store)`` (device "cuda") runs pagerank, sssp,
   bfs and cc through the fused kernel, through the gather + fold kernel,
   and with ``use_kernel=False``; bfs again at prefetch depth 2.  Exact apps
   must agree bitwise, PageRank to ``PR_RTOL``; each kernel's launch count
   must equal the shards its runs processed;
5. batched path — ``run_batch`` of sssp, bfs and ppr at K = 16 through the
   fused kernel, the gather + fold kernel and the plain version: exact apps
   bitwise, ppr to ``PPR_RTOL``, four columns of each exact app equal to
   solo ``run``s, launches equal to the shards processed;
6. service — ``session.service(max_batch=16)`` answers the 16 bfs, 16
   sssp and 16 ppr queries of phase 5 submitted from 8 client threads, two
   runners sweeping at once (ppr has an engine of its own); every sssp/bfs
   answer must equal its ``run_batch`` column bitwise, ppr to
   ``PPR_RTOL``, and the kernels' launches must equal the shards the
   service's sweeps processed;
7. multi-device — ``GraphSession(store, num_devices=2, device=[cuda:0,
   cuda:0])`` (two lanes on the one card, each its own stream and cache
   partition) runs the four apps and ``run_batch("sssp")`` at K = 16, equal
   to phases 4 and 5 (PageRank to ``PR_RTOL``), and sssp and its batch again
   through the gather + fold kernels (B2, B3); ``DistributedVSW`` on
   ``partition_for_mesh`` of the same edges at D = 2 runs cc, sssp, bfs
   (bitwise against phase 4) and pagerank (to ``PR_RTOL``); ``spmv_2d`` on
   the phase-3 tiling at D = S = 2 for plus_times and min_plus, with the
   tiles' extents and without, against its plain version and the 1-D
   ``ops.ell_spmv`` of the same graph.  Each
   run's seconds are printed beside the single-lane ones, and each kernel's
   launches must equal the shards, lane-iterations or tiles it processed.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
SEMIS = ("plus_times", "plus_src", "min_plus", "min_src", "max_src")
DTYPES = ("float32", "float16", "int8")
# plus semirings: a row folds <= 512 positive float32 terms in another order
PLUS_RTOL = 3.1e-5
# PageRank: float32 sums in another order per iteration (hub rows wrap over
# many ELL rows, combined by atomics), damped by 1 / (1 - 0.85) over the run;
# personalized PageRank sums the same terms per column, so the same bound
PR_RTOL = 5e-4
PPR_RTOL = PR_RTOL
CACHE_BUDGET = 16 << 30        # holds the decoded scale-22 store in host RAM
BATCH_K = 16                   # GraphService's default max_batch
EXTRA_KS = (3, 4, 32, 64)      # also checked, on the first EXTRA_SHARDS
EXTRA_SHARDS = 3
TIMED_KS = (4, BATCH_K, 32)    # the batched kernels' float4 loads, by K
# PERF.md's times of the batched kernels before their redesign, one sweep at
# K = 16, plus_src float32 (chip_smoke.py on an H100 80GB HBM3 at 700 W)
EARLIER_MS = {"ell_spmv_fused_batch": 5.004, "ell_fold_batch": 6.038}
KERNEL_SOURCE = "src/repro_torch/kernels/spmv/csrc/ell_spmv.cu"
# the Pallas entry each kernel replaces (B1 serves K = 1 and K > 1)
REPLACES = {"ell_spmv_fused": "src/repro/kernels/spmv/spmv.py:328",
            "ell_fold": "src/repro/kernels/spmv/spmv.py:172",
            "ell_spmv_fused_batch": "src/repro/kernels/spmv/spmv.py:328",
            "ell_fold_batch": "src/repro/kernels/spmv/spmv.py:221",
            "ell_gather_fold": "src/repro/kernels/spmv/spmv.py:276"}
LANES = 2                      # phase 7: lanes, and the D = S of the tiling
TILE_WIDTH = 128               # ELL width of the 2-D tiles


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
def phase_data(tmp: Path, scale: int, edge_factor: int, pool):
    """-> (store, layouts): the preprocessed store, and futures on ``pool``
    for the host arrays phases 3 and 7 lay the same edges out in, built
    while the store is preprocessed: ``layouts["tiles"]`` (``tile_ells``)
    and ``layouts["mesh"][D]`` (``partition_for_mesh`` at D = 1 and
    LANES), each as ``(result, seconds)``."""
    import numpy as np

    from repro_torch.core.distributed import partition_for_mesh
    from repro_torch.graph.generate import rmat_edges
    from repro_torch.graph.preprocess import preprocess_graph
    from repro_torch.graph.storage import write_edge_list

    chunks = []

    def keep(gen):
        for chunk in gen:
            chunks.append(chunk)
            yield chunk

    t0 = time.perf_counter()
    meta = write_edge_list(tmp / "edges", keep(rmat_edges(
        scale, edge_factor, a=0.57, b=0.19, c=0.19, seed=0)))
    src = np.concatenate([c[0] for c in chunks])
    dst = np.concatenate([c[1] for c in chunks])
    del chunks
    n = meta["num_vertices"]
    layouts = dict(tiles=pool.submit(_timed, tile_ells, src, dst, n),
                   mesh={D: pool.submit(_timed, partition_for_mesh, src, dst,
                                        n, D) for D in (LANES, 1)})
    t1 = time.perf_counter()
    store = preprocess_graph(str(tmp / "edges"), str(tmp / "store"))
    t2 = time.perf_counter()
    shutil.rmtree(tmp / "edges")
    disk = sum(f.stat().st_size for f in (tmp / "store").iterdir())
    check(store.num_vertices == n, f"store has {store.num_vertices} "
                                   f"vertices, the edge list {n}")
    log(f"data: rmat scale={scale} edge_factor={edge_factor} "
        f"|V|={meta['num_vertices']} |E|={meta['num_edges']} "
        f"shards={store.num_shards} generate+write_s={t1 - t0:.1f} "
        f"preprocess_s={t2 - t1:.1f} store_bytes={disk}")
    return store, layouts


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def _compare(torch, got, want, plus: bool) -> tuple[bool, float]:
    same = (got == want) | (got.isnan() & want.isnan())
    diff = torch.where(same, torch.zeros_like(got), (got - want).abs())
    if plus:
        ok = bool((diff <= PLUS_RTOL * want.abs()).all())
    else:
        ok = bool(same.all())
    return ok, float(diff.max())


def tile_ells(src, dst, n: int) -> dict:
    """The edges as a D x S = LANES x LANES 2-D tiling, the layout of
    ``spmv_2d``: tile (d, s) holds the edges into destination block d from
    source range s, as blocked-ELL of width ``TILE_WIDTH`` whose cols are
    local to the source range (``build_csr_shards`` + ``csr_to_ell``, on
    the host).  The blocks are ``ceil(n / LANES)`` long, so the last one
    may reach past n.  -> {(d, s): ELLShard}."""
    from repro_torch.core.shards import build_csr_shards, csr_to_ell

    per = vb = -(-n // LANES)
    ells = {}
    for d in range(LANES):
        into = (dst // per) == d
        for s in range(LANES):
            m = into & ((src // vb) == s)
            csr = build_csr_shards(src[m] - s * vb, dst[m] - d * per, per,
                                   threshold_edge_num=1 << 62)[0]
            ells[d, s] = csr_to_ell(csr, max_width=TILE_WIDTH)
            check(ells[d, s].shape[1] == TILE_WIDTH,
                  f"tile width {ells[d, s].shape[1]}")
    return ells


def build_tiles(torch, layouts, n: int, dev) -> dict:
    """``tile_ells``' tiles stacked on the card as ``cols``/``unit``
    [D, S, R, W] (unit edge values), ``row_map`` and the rows' extents
    (``ell_row_extents``, built here once, as the tiles are laid out)
    [D, S, R], with one dict per tile for the kernel phase (its slices of
    an [n] frontier are shorter than ``vb`` where the block reaches past n;
    spmv_2d takes a frontier padded to ``n_pad``)."""
    from repro_torch.kernels.spmv.ops import ell_row_extents

    ells, host_s = layouts["tiles"].result()
    t0 = time.perf_counter()
    per = vb = -(-n // LANES)
    parts = {key: tuple(torch.from_numpy(a).to(dev) for a in
                        (ell.cols, ell.vals, ell.row_map))
             for key, ell in ells.items()}
    del ells
    R = max(p[0].shape[0] for p in parts.values())
    shape = (LANES, LANES, R, TILE_WIDTH)
    cols = torch.full(shape, -1, dtype=torch.int32, device=dev)
    unit = torch.zeros(shape, dtype=torch.float32, device=dev)
    row_map = torch.zeros(shape[:3], dtype=torch.int32, device=dev)
    for (d, s), (c, v, rm) in parts.items():
        r = c.shape[0]
        cols[d, s, :r], unit[d, s, :r], row_map[d, s, :r] = c, v, rm
    del parts
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    extents = ell_row_extents(cols)
    torch.cuda.synchronize()
    ext_s = time.perf_counter() - t1
    tiles = []
    for d in range(LANES):
        for s in range(LANES):
            c = cols[d, s]
            valid = c >= 0
            tiles.append(dict(
                d=d, s=s, cols=c, unit=unit[d, s], extents=extents[d, s],
                rows=R, slots=R * TILE_WIDTH, valid=int(valid.sum()),
                ext_sum=int(extents[d, s].sum()),
                distinct=int(torch.unique(c[valid]).numel()), vb=vb))
    log(f"tiles: {LANES} x {LANES} tiles [R={R}, W={TILE_WIDTH}] of "
        f"{per} destination rows x {vb} sources, built on the host in "
        f"{host_s:.1f}s (beside preprocessing), on the card in "
        f"{time.perf_counter() - t0:.1f}s (row extents {ext_s:.3f}s); "
        f"valid slots {[t['valid'] for t in tiles]}, slots below the "
        f"extents {[t['ext_sum'] for t in tiles]}, mean extent "
        f"{sum(t['ext_sum'] for t in tiles) / (R * len(tiles)):.3f}, "
        f"distinct sources {[t['distinct'] for t in tiles]}")
    return dict(cols=cols, unit=unit, row_map=row_map, extents=extents,
                tiles=tiles, n_pad=per * LANES)


def _quantized(torch, w, dtype: str):
    """``w`` (>= 0, 0 at padding) as ``dtype`` edge values + (scale, zero),
    by ``quantize_edge_vals``' formulas, on the card."""
    import numpy as np

    if dtype == "float32":
        return w, (1.0, 0.0)
    if dtype == "float16":
        return w.half(), (1.0, 0.0)
    scale = float(np.float32(float(w.max()) / 255.0))
    zero = -128.0  # rint(-128 - vmin / scale) with vmin = 0
    q = torch.clamp(torch.round(w / scale + zero), -128, 127)
    return q.to(torch.int8), (scale, zero)


def check_gather_fold(torch, tiling, x, x_inf, gen, hold) -> None:
    """B4 against its plain version on every tile, 5 semirings x 3 dtypes
    of random weights, without and with the tile's row extents.  Keeps
    each tile's float16 and int8 values for the timings."""
    from repro_torch.kernels.spmv import cuda, ref

    for t in tiling["tiles"]:
        cols, vb = t["cols"], t["vb"]
        valid = cols >= 0
        w = torch.where(valid, torch.rand(cols.shape, generator=gen,
                                          device=cols.device) * 9 + 0.5, 0.0)
        for dtype in DTYPES:
            vals, qp = _quantized(torch, w, dtype)
            t[dtype] = (vals, qp)
            deq = ref.maybe_dequantize(vals, qp)
            for sem in SEMIS:
                plus = sem.startswith("plus")
                full = (x if plus else x_inf)[t["s"] * vb:(t["s"] + 1) * vb]
                want = ref.ell_gather_fold_ref(full, cols, deq, sem)
                what = f"tile ({t['d']}, {t['s']}) ({sem}, {dtype})"
                hold("ell_gather_fold",
                     cuda.ell_gather_fold(full, cols, vals, sem, qp), want,
                     plus, what)
                hold("ell_gather_fold",
                     cuda.ell_gather_fold(full, cols, vals, sem, qp,
                                          extents=t["extents"]),
                     want, plus, f"{what} with extents")
        t["float32"] = (t["unit"], (1.0, 0.0))
        del w


def phase_kernels(torch, store, dev, tiling):
    """Hold the kernels against their plain versions on every shard (B4 on
    every tile), then time them over one sweep of the store (B4: of the
    tiling).  Returns the kernel records."""
    import numpy as np

    from repro_torch.core.shards import quantize_shard
    from repro_torch.kernels.spmv import cuda, ref

    n = store.num_vertices
    gen = torch.Generator(device=dev).manual_seed(0)

    def frontier(*shape):
        """(x, x with 20% unreached = inf): min/max semirings see both."""
        x = torch.rand(*shape, generator=gen, device=dev)
        x_inf = x.clone()
        x_inf[torch.rand(*shape, generator=gen, device=dev) < 0.2] = \
            float("inf")
        return x, x_inf

    x, x_inf = frontier(n)
    batch_x = {k: frontier(n, k) for k in (BATCH_K,) + EXTRA_KS}
    rng = np.random.default_rng(0)
    err = {name: 0.0 for name in REPLACES}
    resident = []   # per shard: what the timing sweeps need
    checks = 0

    def hold(name, got, want, plus, what):
        nonlocal checks
        ok, e = _compare(torch, got, want, plus)
        err[name] = max(err[name], e)
        check(ok, f"{name} disagrees with its plain version on {what}: "
                  f"max abs err {e}")
        checks += 1

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
                what = f"shard {p} ({sem}, {dtype})"
                hold("ell_spmv_fused",
                     cuda.ell_spmv_fused(xs, cols, vals, sem, qp), want,
                     plus, what)
                hold("ell_fold", cuda.ell_fold(g, vals, cols, sem, qp),
                     want, plus, what)
        ks = (BATCH_K,) + (EXTRA_KS if p < EXTRA_SHARDS else ())
        for k in ks:
            xk = batch_x[k]
            xgk = (ref.gather(xk[0], cols), ref.gather(xk[1], cols))
            for dtype in DTYPES:
                vals, qp = quantized[dtype]
                deq = ref.maybe_dequantize(vals, qp)
                for sem in SEMIS:
                    plus = sem.startswith("plus")
                    xs, g = xk[not plus], xgk[not plus]
                    want = ref.ell_fold_batch_ref(g, deq, cols, sem)
                    what = f"shard {p} ({sem}, {dtype}, K={k})"
                    hold("ell_spmv_fused_batch",
                         cuda.ell_spmv_fused_batch(xs, cols, vals, sem, qp),
                         want, plus, what)
                    hold("ell_fold_batch",
                         cuda.ell_fold_batch(g, vals, cols, sem, qp), want,
                         plus, what)
                    if k == BATCH_K and p < EXTRA_SHARDS:  # scalar loads
                        hold("ell_spmv_fused_batch",
                             cuda.ell_spmv_fused_batch(_unaligned(torch, xs),
                                                       cols, vals, sem, qp),
                             want, plus, f"{what}, unaligned frontier")
            del xgk
        unit = torch.from_numpy(ell.vals).to(dev)  # the store's own vals
        resident.append(dict(
            cols=cols, unit=unit, xg=xg[False], rows=ell.shape[0],
            slots=ell.shape[0] * ell.shape[1], valid=int(mask.sum()),
            distinct=int(torch.unique(cols[cols >= 0]).numel()),
            float32=(unit, (1.0, 0.0)), float16=quantized["float16"],
            int8=quantized["int8"]))
    check_gather_fold(torch, tiling, x, x_inf, gen, hold)
    torch.cuda.synchronize()
    log(f"kernels: {checks} checks against the plain versions on "
        f"{store.num_shards} shards x {len(SEMIS)} semirings x "
        f"{len(DTYPES)} dtypes (K = 1 and {BATCH_K} on every shard, K = "
        f"{EXTRA_KS} and an unaligned K = {BATCH_K} frontier on "
        f"{EXTRA_SHARDS}; B4 on {len(tiling['tiles'])} tiles, with and "
        f"without extents) passed in {time.perf_counter() - t0:.1f}s; max "
        f"abs err {err}")
    x16 = batch_x[BATCH_K][0]
    del batch_x
    return time_kernels(torch, resident, tiling["tiles"], x, x16, n, err)


def _unaligned(torch, t):
    """A contiguous copy of ``t`` starting 4 bytes past a 16-byte boundary
    (the batched kernels then read one float a lane)."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    skip = 1 + (-buf.data_ptr() // 4) % 4
    view = buf[skip:skip + t.numel()].view(t.shape)
    check(view.data_ptr() % 16 == 4, "unaligned view is aligned")
    return view.copy_(t)


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


def _paired(torch, calls, plain, lib) -> dict:
    """Plain, kernel, kernel, plain (compare within one call, in turns),
    then the library call: device ms and events ms of one pass each."""
    (p1, p1e), (k1, k1e) = _time_sweep(torch, plain), \
        _time_sweep(torch, calls)
    (k2, k2e), (p2, p2e) = _time_sweep(torch, calls), \
        _time_sweep(torch, plain)
    lib_ms, lib_e = _time_sweep(torch, lib)
    return dict(k1=k1, k1e=k1e, k2=k2, k2e=k2e, p1=p1, p1e=p1e, p2=p2,
                p2e=p2e, lib=lib_ms, libe=lib_e)


def _csr(torch, s, n):
    """The shard as a CSR sparse tensor with its unit values at the valid
    slots.  ELL rows hold duplicate, unsorted columns: valid input for a
    sparse product, though not a canonical CSR, so the invariant check is
    off."""
    valid = s["cols"] >= 0
    crow = torch.zeros(s["rows"] + 1, dtype=torch.int64,
                       device=s["cols"].device)
    crow[1:] = valid.sum(1).cumsum(0)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            crow, s["cols"][valid].long(), s["unit"][valid],
            size=(s["rows"], n), check_invariants=False)


def bound_bytes(name: str, s: dict, val_bytes: int, k: int,
                extents: bool = False) -> int:
    """Least bytes one call on shard ``s`` moves: each input read once, the
    output written once.  cols (4 B a slot), the edge values (``val_bytes``
    a slot; the *_src semirings never read them), the sources — the
    frontier's rows at the shard's distinct source vertices (fused; B4: the
    tile's distinct local sources), every slot of the gathered ``xg``
    (ell_fold, which reads it whole), or ``xg`` at the valid slots only
    (ell_fold_batch reads no source for a padding slot) — and the [R, k]
    float32 partials.  B4 with ``extents``: 4 B of extent a row, and cols
    (and values) at the slots below the rows' extents only."""
    if extents:
        return (4 * s["rows"] + s["ext_sum"] * (4 + val_bytes)
                + 4 * s["distinct"] + 4 * s["rows"])
    edges = s["slots"] * (4 + val_bytes)
    if name.startswith("ell_spmv_fused") or name == "ell_gather_fold":
        src = 4 * k * s["distinct"]
    elif name == "ell_fold":
        src = 4 * s["slots"]
    else:
        src = 4 * k * s["valid"]
    return edges + src + 4 * k * s["rows"]


def _bound_ms(name, items, val_bytes, k, extents=False) -> tuple:
    """(bytes, ms at the HBM rate) of one pass over ``items``."""
    nbytes = sum(bound_bytes(name, s, val_bytes, k, extents) for s in items)
    return nbytes, nbytes / HBM_BYTES_PER_S * 1e3


def _gathered_chunks(torch, resident, xk, k: int, timed) -> dict:
    """``timed(chunk, xgs)`` over chunks of shards whose gathered [R, W, k]
    sources (``xgs``, gathered outside the timed region) fit on the card,
    summed key by key: the gathered sources of all shards would not (0.69e9
    slots x 4k B at scale 22)."""
    from repro_torch.kernels.spmv import ref

    totals: dict = {}
    chunk: list = []

    def flush():
        xgs = [ref.gather(xk, s["cols"]) for s in chunk]
        for key, ms in timed(chunk, xgs).items():
            totals[key] = totals.get(key, 0.0) + ms
        chunk.clear()

    for s in resident:
        chunk.append(s)
        if sum(c["slots"] for c in chunk) * 4 * k > 12e9:
            flush()
    if chunk:
        flush()
    return totals


def time_kernels(torch, resident, tiles, x, x16, n, err):
    from repro_torch.kernels.spmv import cuda, ref

    sem = "plus_src"  # PageRank's semiring, over the store's float32 vals
    csrs = [_csr(torch, s, n) for s in resident]
    xcol = x[:, None]
    # each tile's source block, of the frontier padded with zeros to the
    # tiling's LANES * vb vertices (the sparse product wants all vb rows)
    xp = torch.cat([x, x.new_zeros(LANES * tiles[0]["vb"] - n)])
    for t in tiles:
        t["x"] = xp[t["s"] * t["vb"]:(t["s"] + 1) * t["vb"]]
    tile_csrs = [_csr(torch, t, t["vb"]) for t in tiles]

    def b4(t, sem, vals, qp=None, extents=True):
        return cuda.ell_gather_fold(t["x"], t["cols"], vals, sem, qp,
                                    extents=t["extents"] if extents else None)

    sweeps = {
        "ell_spmv_fused": (
            [lambda s=s: cuda.ell_spmv_fused(x, s["cols"], s["unit"], sem)
             for s in resident],
            [lambda s=s: ref.ell_fold_ref(ref.gather(x, s["cols"]),
                                          s["unit"], s["cols"], sem)
             for s in resident],
            # a CSR sparse product
            [lambda c=c: torch.sparse.mm(c, xcol) for c in csrs]),
        "ell_fold": (
            [lambda s=s: cuda.ell_fold(s["xg"], s["unit"], s["cols"], sem)
             for s in resident],
            [lambda s=s: ref.ell_fold_ref(s["xg"], s["unit"], s["cols"], sem)
             for s in resident],
            # a row-wise dot product with the unit vals (0 at sentinels)
            [lambda s=s: torch.linalg.vecdot(s["unit"], s["xg"])
             for s in resident]),
        "ell_spmv_fused_batch": (
            [lambda s=s: cuda.ell_spmv_fused_batch(x16, s["cols"], s["unit"],
                                                   sem) for s in resident],
            [lambda s=s: ref.ell_fold_batch_ref(ref.gather(x16, s["cols"]),
                                                s["unit"], s["cols"], sem)
             for s in resident],
            [lambda c=c: torch.sparse.mm(c, x16) for c in csrs]),
        # the main path's B4 reads each row up to its extent
        "ell_gather_fold": (
            [lambda t=t: b4(t, sem, t["unit"]) for t in tiles],
            [lambda t=t: ref.ell_gather_fold_ref(t["x"], t["cols"],
                                                 t["unit"], sem)
             for t in tiles],
            # a CSR sparse product of the tile's [R, VB] by its block
            [lambda c=c, t=t: torch.sparse.mm(c, t["x"][:, None])
             for c, t in zip(tile_csrs, tiles)]),
    }
    # the library calls must compute what the kernels compute
    s0 = resident[0]
    k0 = cuda.ell_spmv_fused(x, s0["cols"], s0["unit"], sem)
    check(torch.allclose(torch.sparse.mm(csrs[0], xcol), k0, rtol=PLUS_RTOL,
                         atol=0), "sparse.mm differs from ell_spmv_fused")
    check(torch.allclose(torch.linalg.vecdot(s0["unit"], s0["xg"])[:, None],
                         k0, rtol=PLUS_RTOL, atol=0),
          "vecdot differs from ell_fold")
    k0 = cuda.ell_spmv_fused_batch(x16, s0["cols"], s0["unit"], sem)
    check(torch.allclose(torch.sparse.mm(csrs[0], x16), k0, rtol=PLUS_RTOL,
                         atol=0), "sparse.mm differs from ell_spmv_fused_batch")
    xg16 = ref.gather(x16, s0["cols"])
    check(torch.allclose(torch.einsum("rw,rwk->rk", s0["unit"], xg16), k0,
                         rtol=PLUS_RTOL, atol=0),
          "einsum differs from ell_fold_batch")
    t0 = tiles[0]
    check(torch.allclose(torch.sparse.mm(tile_csrs[0], t0["x"][:, None]),
                         b4(t0, sem, t0["unit"]), rtol=PLUS_RTOL, atol=0),
          "sparse.mm differs from ell_gather_fold with extents")
    del xg16
    times = {name: _paired(torch, *calls) for name, calls in sweeps.items()}
    del sweeps
    times["ell_fold_batch"] = _gathered_chunks(
        torch, resident, x16, BATCH_K, lambda chunk, xgs: _paired(
            torch,
            [lambda s=s, g=g: cuda.ell_fold_batch(g, s["unit"], s["cols"],
                                                  sem)
             for s, g in zip(chunk, xgs)],
            [lambda s=s, g=g: ref.ell_fold_batch_ref(g, s["unit"],
                                                     s["cols"], sem)
             for s, g in zip(chunk, xgs)],
            # plus_times over the unit vals (0 at sentinels) = plus_src
            [lambda s=s, g=g: torch.einsum("rw,rwk->rk", s["unit"], g)
             for s, g in zip(chunk, xgs)]))

    records = {}
    for name, t in times.items():
        k = BATCH_K if name.endswith("_batch") else 1
        items = tiles if name == "ell_gather_fold" else resident
        b4_ext = name == "ell_gather_fold"
        nbytes, bound = _bound_ms(name, items, 0, k, extents=b4_ext)
        ms = min(t["k1"], t["k2"])
        records[name] = dict(
            name=name, route="cuda", source=KERNEL_SOURCE,
            replaces=REPLACES[name], launches=None,
            max_abs_err=err[name], ms=ms, plain_ms=min(t["p1"], t["p2"]),
            bound_ms=bound, bound_by="bytes", library_ms=t["lib"])
        log(f"timing: {name} K={k} {sem} float32"
            f"{', with extents' if b4_ext else ''}, one sweep = "
            f"{len(items)} launches, device ms (events ms): kernel "
            f"{t['k1']:.4f} ({t['k1e']:.4f}) / {t['k2']:.4f} "
            f"({t['k2e']:.4f}), plain {t['p1']:.4f} ({t['p1e']:.4f}) / "
            f"{t['p2']:.4f} ({t['p2e']:.4f}), library {t['lib']:.4f} "
            f"({t['libe']:.4f}); bound {bound:.4f} ms ({nbytes} bytes at "
            f"3.35 TB/s); {nbytes / ms / 1e9:.2f} TB/s, {bound / ms:.0%} of "
            "the bound")
    # B4 without extents walks every slot, as the kernel before extents
    # did: with, without, without, with, in turns
    walks = {e: [lambda t=t, e=e: b4(t, sem, t["unit"], extents=e)
                 for t in tiles] for e in (True, False)}
    (e1, _), (f1, _), (f2, _), (e2, _) = [
        _time_sweep(torch, walks[e]) for e in (True, False, False, True)]
    b4_ms = {True: min(e1, e2), False: min(f1, f2)}
    full_bytes, full_bound = _bound_ms("ell_gather_fold", tiles, 0, 1)
    ext_bytes, ext_bound = _bound_ms("ell_gather_fold", tiles, 0, 1, True)
    log(f"timing: ell_gather_fold {sem} float32, one pass over "
        f"{len(tiles)} tiles, device ms: with extents {e1:.4f} / {e2:.4f}, "
        f"without {f1:.4f} / {f2:.4f}; full-ELL bound {full_bound:.4f} ms "
        f"({full_bytes} bytes: every slot's col), extent bound "
        f"{ext_bound:.4f} ms ({ext_bytes} bytes: extents, cols below them); "
        f"without extents {full_bound / b4_ms[False]:.0%} of the full-ELL "
        f"bound, with extents {ext_bound / b4_ms[True]:.0%} of the extent "
        f"bound; library (sparse.mm) "
        f"{records['ell_gather_fold']['library_ms']:.4f}")
    scaling = time_batched_scaling(torch, resident, n, sem, {
        name: min((times[name]["k1"], times[name]["k1e"]),
                  (times[name]["k2"], times[name]["k2e"]))
        for name in EARLIER_MS})
    log(f"timing: before -> after, one sweep, {sem} float32: "
        f"ell_gather_fold {b4_ms[False]:.4f} (without extents: the full "
        f"row walk) -> {b4_ms[True]:.4f} (with extents), this run; "
        + "; ".join(f"{name} K={BATCH_K} {EARLIER_MS[name]:.3f} (PERF.md, "
                    f"before the redesign) -> {scaling[name, BATCH_K][0]:.4f}"
                    for name in EARLIER_MS))
    # SSSP/BFS's semiring reads the edge values: the store's float32 unit
    # values, and the float16/int8 ones a weighted store would hold
    sem = "min_plus"
    for dtype, val_bytes in (("float32", 4), ("float16", 2), ("int8", 1)):
        for name in ("ell_spmv_fused", "ell_fold", "ell_spmv_fused_batch",
                     "ell_gather_fold", "ell_gather_fold (no extents)"):
            items = tiles if name.startswith("ell_gather_fold") else resident
            if name.startswith("ell_gather_fold"):
                calls = [lambda t=t, e=name == "ell_gather_fold": b4(
                    t, "min_plus", *t[dtype], extents=e) for t in tiles]
            elif name == "ell_spmv_fused":
                calls = [lambda s=s: cuda.ell_spmv_fused(
                    x, s["cols"], s[dtype][0], sem, s[dtype][1])
                    for s in resident]
            elif name == "ell_fold":
                calls = [lambda s=s: cuda.ell_fold(
                    s["xg"], s[dtype][0], s["cols"], sem, s[dtype][1])
                    for s in resident]
            else:
                calls = [lambda s=s: cuda.ell_spmv_fused_batch(
                    x16, s["cols"], s[dtype][0], sem, s[dtype][1])
                    for s in resident]
            ms, ev = _time_sweep(torch, calls)
            k = BATCH_K if name.endswith("_batch") else 1
            nbytes, bound = _bound_ms(name.split()[0], items, val_bytes, k,
                                      extents=name == "ell_gather_fold")
            log(f"timing: {name} K={k} {sem} {dtype} vals, one sweep: "
                f"kernel {ms:.4f} ms device ({ev:.4f} events), bound "
                f"{bound:.4f} ms, {nbytes / ms / 1e9:.2f} TB/s, "
                f"{bound / ms:.0%} of the bound")
    for t in tiles:  # the timings' values; phase 7 keeps cols/unit only
        for key in ("x", "float16", "int8", "float32"):
            t.pop(key, None)
    return records


def time_batched_scaling(torch, resident, n, sem, paired) -> dict:
    """The batched kernels (B1, and B3 over sources gathered outside the
    timed region) at each K of TIMED_KS, one sweep each: float4 source
    loads at every K here.  -> {(name, K): (device ms, events ms)}; K =
    BATCH_K is the paired timing's, ``paired[name]``."""
    from repro_torch.kernels.spmv import cuda

    gen = torch.Generator(device=resident[0]["cols"].device).manual_seed(3)
    out = {}
    for k in TIMED_KS:
        if k == BATCH_K:
            for name in paired:
                out[name, k] = paired[name]
            continue
        xk = torch.rand(n, k, generator=gen, device=gen.device)
        out["ell_spmv_fused_batch", k] = _time_sweep(
            torch, [lambda s=s: cuda.ell_spmv_fused_batch(
                xk, s["cols"], s["unit"], sem) for s in resident])
        fold = _gathered_chunks(
            torch, resident, xk, k, lambda chunk, xgs: dict(zip(
                ("ms", "ev"), _time_sweep(torch, [
                    lambda s=s, g=g: cuda.ell_fold_batch(
                        g, s["unit"], s["cols"], sem)
                    for s, g in zip(chunk, xgs)]))))
        out["ell_fold_batch", k] = fold["ms"], fold["ev"]
        del xk
    for name in ("ell_spmv_fused_batch", "ell_fold_batch"):
        parts = []
        for k in TIMED_KS:
            ms, ev = out[name, k]
            _, bound = _bound_ms(name, resident, 0, k)
            parts.append(f"K={k} {ms:.4f} ({ev:.4f}) ms (bound "
                         f"{bound:.4f}, {bound / ms:.0%})")
        log(f"timing: {name} {sem} float32 by K, one sweep, device ms "
            f"(events ms): " + ", ".join(parts))
    return out


# --------------------------------------------------------------------------
def phase_main_path(torch, store_path: str):
    """One GraphSession on the card: the four apps through each kernel and
    through the plain version; bfs at prefetch 0 and 2.  Returns the launch
    counts of the run and its results by (variant, app)."""
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
        r = profile_run(torch, "bfs",
                        lambda: s.run("bfs", config=base, source=0))
        check(np.array_equal(r.values, results["fused", "bfs"].values),
              "bfs under torch.profiler differs from the main path's bfs")
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
    return launches, results


def profile_run(torch, label: str, run):
    """One more run (warm cache, prefetch depth 0) under torch.profiler: the
    device's busy share of the run's seconds and where device time goes.
    Returns ``run()``'s result; its launches come after the phase's counts
    were read."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():  # "clears events at end of cycle"
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r = run()
            torch.cuda.synchronize()
    device = [(e.self_device_time_total, e.key, e.count)
              for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    # the run's own iteration seconds (the profiler's start-up is outside
    # them, its per-op overhead inside): the share is a lower bound
    busy = sum(d[0] for d in device) / 1e6
    log(f"profile: {label} under torch.profiler "
        f"seconds={r.total_seconds:.3f} device_busy_s={busy:.3f} "
        f"busy_share={busy / r.total_seconds:.3f}")
    for us, key, count in sorted(device, reverse=True)[:6]:
        log(f"profile:   {us / 1e3:10.2f} ms  x{count:<6d} {key[:90]}")
    return r


# --------------------------------------------------------------------------
def _max_rel_err(np, got, want) -> float:
    """Largest |got - want| / |want| where the two differ (inf where want
    is 0 and got is not)."""
    diff = np.where(got == want, 0.0, np.abs(got - want))
    with np.errstate(divide="ignore", invalid="ignore"):
        rel = np.where(diff == 0, 0.0, diff / np.abs(want))
    return float(rel.max())


def phase_batched(torch, store_path: str, solo):
    """The batched path and the service on one warm GraphSession.  ``solo``
    holds the main path's results (sssp/bfs from source 0).  Returns the
    launch counts of the run_batch phase and ``(sources, the fused sssp
    columns)`` for phase 7."""
    import numpy as np

    from repro_torch.session import GraphSession

    with GraphSession(store_path, cache_mode=1,
                      cache_budget_bytes=CACHE_BUDGET) as s:
        t0 = time.perf_counter()
        s.warm()
        log(f"batch: cache warmed in {time.perf_counter() - t0:.1f}s")
        # vertex 0 (the RMAT hub, slice 1's source) and 15 other vertices
        # with out-edges, from a fixed seed
        cand = np.nonzero(s.out_deg > 0)[0]
        rng = np.random.default_rng(1)
        sources = [0] + sorted(int(v) for v in rng.choice(
            cand[cand != 0], BATCH_K - 1, replace=False))
        launches, cols = run_batch_path(torch, s, sources, solo)
        profile_run(torch, f"bfs K={BATCH_K}",
                    lambda: (s.run_batch("bfs", sources=sources),
                             s.last_batch_result)[1])
        run_service(torch, s, sources, cols)
    return launches, (sources, cols["sssp"])


def run_batch_path(torch, s, sources, solo):
    """run_batch of sssp, bfs and ppr at K = BATCH_K through the fused
    kernel, the gather + fold kernel and the plain version."""
    import numpy as np

    from repro_torch.kernels.spmv import cuda

    runs = [("sssp", {}), ("bfs", {}), ("ppr", dict(max_iters=10))]
    base = s.config
    variants = {"fused": base,
                "gather+fold": base.replace(fused_gather=False),
                "plain": base.replace(use_kernel=False)}
    results, cols = {}, {}
    shards_by_kernel = {"ell_spmv_fused_batch": 0, "ell_fold_batch": 0}
    cuda.reset_launches()
    for variant, cfg in variants.items():
        for app, kw in runs:
            t0 = time.perf_counter()
            columns = s.run_batch(app, sources=sources, config=cfg, **kw)
            wall = time.perf_counter() - t0
            r = s.last_batch_result
            shards = sum(h.shards_processed for h in r.history)
            if cfg.use_kernel is not False:
                key = ("ell_spmv_fused_batch" if cfg.fused_gather
                       else "ell_fold_batch")
                shards_by_kernel[key] += shards
            fetch = sum(h.fetch_seconds for h in r.history)
            log(f"batch: {variant:12s} {app:5s} K={r.num_columns} "
                f"iterations={r.iterations} "
                f"column_iterations={r.column_iterations.tolist()} "
                f"seconds={r.total_seconds:.3f} wall_s={wall:.3f} "
                f"per_query_s={r.total_seconds / r.num_columns:.4f} "
                f"shards={shards} fetch_s={fetch:.3f}")
            check(r.values.shape == (s.n, len(sources))
                  and np.isfinite(r.values).any(),
                  f"{variant} {app}: bad batched values")
            results[variant, app] = r
            cols[variant, app] = columns
    launches = dict(cuda.launches)
    for name, want in shards_by_kernel.items():
        check(launches[name] == want and want > 0,
              f"{name}: {launches[name]} launches on the batched path, "
              f"expected one per processed shard ({want})")
    for app, _ in runs:
        want = results["plain", app]
        for variant in ("fused", "gather+fold"):
            r = results[variant, app]
            check(r.iterations == want.iterations
                  and np.array_equal(r.column_iterations,
                                     want.column_iterations),
                  f"{variant} {app}: iterations {r.column_iterations} "
                  f"differ from plain {want.column_iterations}")
            if app == "ppr":
                rel = _max_rel_err(np, r.values, want.values)
                log(f"batch: ppr {variant} vs plain max rel err {rel:.3e} "
                    f"(rtol {PPR_RTOL})")
                check(rel <= PPR_RTOL, f"ppr {variant} off by {rel}")
            else:
                check(np.array_equal(r.values, want.values),
                      f"{app} {variant} differs from the plain run")
    # four columns of each exact app against solo runs: source 0 is the
    # main path's own run, the next three are run here
    for app in ("sssp", "bfs"):
        batch = cols["fused", app]
        solo_s = solo["fused", app].total_seconds
        check(np.array_equal(batch[0].values, solo["fused", app].values)
              and batch[0].iterations == solo["fused", app].iterations,
              f"{app} column 0 differs from the main path's solo run")
        for k in (1, 2, 3):
            r = s.run(app, source=sources[k])
            check(np.array_equal(batch[k].values, r.values)
                  and batch[k].iterations == r.iterations,
                  f"{app} column {k} differs from its solo run")
        t = results["fused", app].total_seconds
        log(f"batch: {app} K={len(sources)} fused {t:.3f}s for "
            f"{len(sources)} queries vs solo {solo_s:.3f}s for one: "
            f"{len(sources) * solo_s / t:.2f}x the solo queries/s")
    log(f"batch: all comparisons passed; launches {launches}")
    return launches, {app: cols["fused", app] for app, _ in runs}


def run_service(torch, s, sources, cols) -> None:
    """The phase-5 bfs, sssp and ppr queries, submitted from 8 client
    threads to ``s.service(max_batch=16)``; each answer must equal its
    run_batch column (ppr to PPR_RTOL), and the kernels' launches the
    shards the sweeps processed."""
    import numpy as np

    from repro_torch.kernels.spmv import cuda

    queries = [(app, k) for app in ("bfs", "sssp", "ppr")
               for k in range(len(sources))]
    kwargs = {"bfs": {}, "sssp": {}, "ppr": dict(max_iters=10)}
    param = {"bfs": "source", "sssp": "source", "ppr": "seed"}
    shards = []
    s.iteration_observers.append(lambda st: shards.append(
        st.shards_processed))
    answers, errors = {}, []
    with s.service(max_batch=BATCH_K, max_wait_ms=50.0, max_inflight=2,
                   memoize=False) as svc:
        def client(tid):
            try:
                futs = [(i, svc.submit(app, **{param[app]: sources[k]},
                                       **kwargs[app]))
                        for i, (app, k) in enumerate(queries)
                        if i % 8 == tid]
                for i, f in futs:
                    answers[i] = f.result(timeout=600)
            except BaseException as exc:  # noqa: BLE001 — checked below
                errors.append(exc)

        cuda.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        snap = svc.stats.snapshot()
    launches = dict(cuda.launches)
    s.iteration_observers.clear()
    check(not errors and not any(t.is_alive() for t in threads),
          f"service clients failed: {errors}")
    ppr_err = 0.0
    for i, (app, k) in enumerate(queries):
        got, want = answers[i].values, cols[app][k].values
        if app == "ppr":
            ppr_err = max(ppr_err, _max_rel_err(np, got, want))
            check(ppr_err <= PPR_RTOL, f"service ppr seed {sources[k]} off "
                                       f"its run_batch column by {ppr_err}")
        else:
            check(np.array_equal(got, want),
                  f"service {app} source {sources[k]} differs from its "
                  "run_batch column")
    fused = launches["ell_spmv_fused"] + launches["ell_spmv_fused_batch"]
    check(fused == sum(shards) > 0
          and launches["ell_fold"] + launches["ell_fold_batch"] == 0,
          f"service: launches {launches}, expected {sum(shards)} fused")
    log(f"service: {len(queries)} queries from 8 threads in {wall:.3f}s: "
        f"qps={len(queries) / wall:.3f} p50_ms={snap['p50_ms']:.1f} "
        f"p99_ms={snap['p99_ms']:.1f} "
        f"batch_occupancy={snap['batch_occupancy']} launches={launches}; "
        f"sssp/bfs answers equal their run_batch columns, ppr max rel err "
        f"{ppr_err:.3e}")


# --------------------------------------------------------------------------
def phase_multi(torch, dev, store_path: str, mesh, n: int, tiling, solo,
                batch) -> int:
    """The multi-device engines on LANES lanes of ``dev`` (one card: the
    lanes share it, each with its own streams).  ``solo`` holds phase 4's
    results by (variant, app), ``batch`` phase 5's ``(sources, fused sssp
    columns)``.  Returns B4's launches in the spmv_2d runs."""
    lanes = [dev] * LANES
    multi_session(torch, store_path, lanes, solo, batch)
    torch.cuda.empty_cache()
    return multi_resident(torch, dev, mesh, n, tiling, solo)


def multi_session(torch, store_path, lanes, solo, batch) -> None:
    """GraphSession(num_devices=LANES) against the single-lane phases:
    exact apps and the batch's columns bitwise, PageRank to PR_RTOL, equal
    iteration counts; per-lane disk bytes sum to each iteration's total and
    B1 runs once per shard the lanes processed.  Then sssp and its batch
    through the gather + fold kernels (B2, B3), held the same way."""
    import numpy as np

    from repro_torch.kernels.spmv import cuda
    from repro_torch.session import GraphSession

    runs = [("pagerank", dict(max_iters=10)), ("sssp", dict(source=0)),
            ("bfs", dict(source=0)), ("cc", {})]
    sources, want_cols = batch
    with GraphSession(store_path, num_devices=LANES, device=lanes,
                      cache_mode=1, cache_budget_bytes=CACHE_BUDGET) as s:
        cuda.reset_launches()
        shards = 0
        for app, kw in runs:
            r = s.run(app, **kw)
            one = solo["fused", app]
            shards += sum(h.shards_processed for h in r.history)
            per_lane = np.sum([h.device_disk_bytes for h in r.history], 0)
            check(all(len(h.device_disk_bytes) == LANES
                      and sum(h.device_disk_bytes) == h.disk_bytes
                      for h in r.history),
                  f"{app}: per-lane disk bytes do not sum to the total")
            check(r.iterations == one.iterations,
                  f"{app}: {r.iterations} iterations on {LANES} lanes, "
                  f"{one.iterations} on one")
            if app == "pagerank":
                rel = _max_rel_err(np, r.values, one.values)
                check(rel <= PR_RTOL, f"pagerank on {LANES} lanes off by "
                                      f"{rel}")
                agree = f"max rel err {rel:.3e} (rtol {PR_RTOL})"
            else:
                check(np.array_equal(r.values, one.values),
                      f"{app} on {LANES} lanes differs from one lane")
                agree = "bitwise equal"
            log(f"multi: session D={LANES} {app:8s} "
                f"iterations={r.iterations} seconds={r.total_seconds:.3f} "
                f"(D = 1: {one.total_seconds:.3f}) lane_disk_bytes="
                f"{per_lane.tolist()} fetch_s="
                f"{sum(h.fetch_seconds for h in r.history):.3f}; {agree}")
        launches = dict(cuda.launches)
        check(launches["ell_spmv_fused"] == shards > 0,
              f"session on {LANES} lanes: launches {launches}, expected "
              f"{shards} of ell_spmv_fused (one per processed shard)")
        cuda.reset_launches()
        cols = s.run_batch("sssp", sources=sources)
        r = s.last_batch_result
        launches = dict(cuda.launches)
        shards = sum(h.shards_processed for h in r.history)
        check(launches["ell_spmv_fused_batch"] == shards > 0,
              f"run_batch on {LANES} lanes: launches {launches}, expected "
              f"{shards} of ell_spmv_fused_batch")
        for k, (got, want) in enumerate(zip(cols, want_cols, strict=True)):
            check(np.array_equal(got.values, want.values)
                  and got.iterations == want.iterations,
                  f"run_batch sssp column {k} on {LANES} lanes differs "
                  "from phase 5's")
        report = s.cache_report()
        check(report["policy"] == "partitioned"
              and report["num_partitions"] == LANES,
              f"cache report {report['policy']} {report['num_partitions']}")
        log(f"multi: session D={LANES} run_batch sssp K={len(sources)} "
            f"iterations={r.iterations} seconds={r.total_seconds:.3f}; all "
            f"{len(sources)} columns equal phase 5's; partition cached bytes "
            f"{[p['cached_bytes'] for p in report['partitions']]}; "
            f"launches {launches}")
        # the lanes' gather + fold route: B2 for a run, B3 for a batch
        cfg = s.config.replace(fused_gather=False)
        cuda.reset_launches()
        rs = s.run("sssp", source=0, config=cfg)
        b2 = sum(h.shards_processed for h in rs.history)
        one = solo["gather+fold", "sssp"]
        check(np.array_equal(rs.values, one.values)
              and rs.iterations == one.iterations,
              f"sssp through gather + fold on {LANES} lanes differs from "
              "phase 4's")
        gcols = s.run_batch("sssp", sources=sources, config=cfg)
        rb = s.last_batch_result
        b3 = sum(h.shards_processed for h in rb.history)
        fold_launches = dict(cuda.launches)
        check(fold_launches["ell_fold"] == b2 > 0
              and fold_launches["ell_fold_batch"] == b3 > 0
              and fold_launches["ell_spmv_fused"]
              + fold_launches["ell_spmv_fused_batch"] == 0,
              f"gather + fold on {LANES} lanes: launches {fold_launches}, "
              f"expected {b2} of ell_fold and {b3} of ell_fold_batch")
        for k, (got, want) in enumerate(zip(gcols, want_cols, strict=True)):
            check(np.array_equal(got.values, want.values)
                  and got.iterations == want.iterations,
                  f"gather + fold run_batch sssp column {k} on {LANES} "
                  "lanes differs from phase 5's")
        log(f"multi: session D={LANES} gather+fold sssp "
            f"seconds={rs.total_seconds:.3f} (D = 1: {one.total_seconds:.3f}"
            f"), run_batch sssp K={len(sources)} "
            f"seconds={rb.total_seconds:.3f}; equal to phases 4 and 5; "
            f"launches {fold_launches}")


def multi_resident(torch, dev, mesh, n, tiling, solo) -> int:
    """DistributedVSW at D = 1 and LANES on ``partition_for_mesh`` of the
    edges (``mesh``: phase 2's futures), then spmv_2d on the phase-3 tiling
    against its plain version and the 1-D ``ops.ell_spmv``.  Returns B4's
    launches in the spmv_2d runs."""
    import numpy as np

    from repro_torch.core.apps import get_app
    from repro_torch.core.distributed import DistributedVSW, spmv_2d
    from repro_torch.kernels.spmv import cuda, ops

    graphs, secs = {}, {}
    for D in (1, LANES):
        graphs[D], secs[D] = mesh[D].result()
    took = ", ".join(f"{t:.1f}s at D = {D}" for D, t in secs.items())
    log(f"multi: partition_for_mesh built on the host (beside "
        f"preprocessing) in {took}; [D, R, W] = "
        f"{[list(g.cols.shape) for g in graphs.values()]}")
    runs = [("cc", {}, 200), ("sssp", dict(source=0), 200),
            ("bfs", dict(source=0), 200), ("pagerank", {}, 10)]
    for app, kw, iters in runs:
        got = {}
        for D, g in graphs.items():
            eng = DistributedVSW(g, get_app(app, **kw), [dev] * D)
            cuda.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            values, it = eng.run(iters)
            torch.cuda.synchronize()
            got[D] = (values, it, time.perf_counter() - t0)
            launches = dict(cuda.launches)
            check(launches["ell_spmv_fused"] == eng.lane_sweeps > 0,
                  f"DistributedVSW D={D} {app}: launches {launches}, "
                  f"expected {eng.lane_sweeps} (one per lane a sweep)")
            del eng
        (v1, it1, s1), (v2, it2, s2) = got[1], got[LANES]
        check(it1 == it2, f"DistributedVSW {app}: {it2} iterations at D = "
                          f"{LANES}, {it1} at D = 1")
        if app == "pagerank":
            rel = _max_rel_err(np, v2, v1)
            check(rel <= PR_RTOL, f"DistributedVSW pagerank off by {rel}")
            agree = f"max rel err {rel:.3e} against D = 1 (rtol {PR_RTOL})"
        else:
            one = solo["fused", app]
            check(np.array_equal(v2, one.values)
                  and np.array_equal(v1, one.values),
                  f"DistributedVSW {app} differs from phase 4's session run")
            agree = (f"D = 1 and {LANES} bitwise equal to phase 4 "
                     f"({one.iterations} iterations there)")
        log(f"multi: DistributedVSW {app:8s} iterations={it2} "
            f"seconds D={LANES}: {s2:.3f} (D = 1: {s1:.3f}); {agree}")

    # spmv_2d on the LANES x LANES tiling against its plain version and the
    # 1-D product of the same edges (partition_for_mesh at D = 1)
    g1 = graphs[1]
    del graphs
    one_d = [torch.from_numpy(a[0]).to(dev)
             for a in (g1.cols, g1.vals, g1.row_map)]
    del g1
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.rand(tiling["n_pad"], generator=gen, device=dev)
    grid = [[dev] * LANES for _ in range(LANES)]
    per = tiling["n_pad"] // LANES
    b4 = 0
    for sem in ("plus_times", "min_plus"):
        plus = sem.startswith("plus")
        args = (x, tiling["cols"], tiling["unit"], tiling["row_map"], sem)
        cuda.reset_launches()
        outs, secs = {}, {}
        # the main path reads each row up to its extent; the full row walk
        # must give the same
        for walk, ext in (("extents", tiling["extents"]), ("full", None)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[walk] = spmv_2d(*args, devices=grid, extents=ext)
            torch.cuda.synchronize()
            secs[walk] = time.perf_counter() - t0
        launches = dict(cuda.launches)
        b4 += launches["ell_gather_fold"]
        check(launches["ell_gather_fold"] == 2 * LANES * LANES,
              f"spmv_2d {sem}: launches {launches}, expected "
              f"{2 * LANES * LANES} of ell_gather_fold (one a tile a call)")
        plain = spmv_2d(*args, devices=grid, use_kernel=False)
        e_plain = {}
        for walk, got in outs.items():
            ok, e_plain[walk] = _compare(torch, got, plain, plus)
            check(ok, f"spmv_2d {sem} ({walk} rows) differs from its plain "
                      f"version by {e_plain[walk]}")
        got = outs["extents"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ops.ell_spmv(x[:n], one_d[0], one_d[1], one_d[2],
                            one_d[0].shape[0], sem)[:n]
        torch.cuda.synchronize()
        t_1d = time.perf_counter() - t0
        ok, e_1d = _compare(torch, got[:, :per].reshape(-1)[:n], want,
                            plus)
        check(ok, f"spmv_2d {sem} differs from the 1-D ell_spmv by {e_1d}")
        log(f"multi: spmv_2d {sem} on {LANES} x {LANES} tiles "
            f"seconds={secs['extents']:.4f} with extents, "
            f"{secs['full']:.4f} without (1-D ell_spmv: {t_1d:.4f}); max "
            f"abs err {e_plain} against its plain version, {e_1d} against "
            f"the 1-D product; launches {launches}")
    return b4


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
    started = time.perf_counter()
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
    # host-side layouts of phases 3 and 7, built while phase 2 preprocesses
    pool = ThreadPoolExecutor(max_workers=2, thread_name_prefix="layouts")
    try:
        store, layouts = phase_data(tmp, args.scale, args.edge_factor, pool)
        n = store.num_vertices
        build_thread.join()
        if "error" in build:
            raise build["error"]
        log(f"device: kernels built in {build['seconds']:.1f}s "
            f"({cuda.library_path().name})")
        tiling = build_tiles(torch, layouts, n, dev)
        records = phase_kernels(torch, store, dev, tiling)
        torch.cuda.empty_cache()
        launches, solo = phase_main_path(torch, str(store.path))
        torch.cuda.empty_cache()
        batch_launches, batch = phase_batched(torch, str(store.path), solo)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches["ell_gather_fold"] = phase_multi(
            torch, torch.device("cuda", 0), str(store.path),
            layouts["mesh"], n, tiling, solo, batch)
        log(f"multi: all comparisons passed in "
            f"{time.perf_counter() - t0:.1f}s")
    finally:
        build_thread.join()
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    # launches: run (K = 1), run_batch (K = 16), spmv_2d (B4)
    for name, rec in records.items():
        rec["launches"] = (batch_launches if name.endswith("_batch")
                           else launches)[name]
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - started:.1f}s")
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
