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
   launches must equal the shards, lane-iterations or tiles it processed;
8. storage and mutation — (a) ``pack_graph`` of the store, then
   ``backend="packed"`` runs the four apps and ``backend="memory"`` bfs and
   sssp, equal to phase 4 (values, iterations, shards processed, disk
   bytes); (b) ``mutable=True`` over the packed file: cold sssp, bfs and cc
   from source 0, a commit of 4,096 new unit-weight edges (seed 2: sources
   uniform over the vertices with out-edges, destinations uniform over the
   intervals of 4 shards), then ``run_incremental`` of each, bitwise equal
   to a cold run and sweeping no more shards, and sssp through the gather +
   fold kernel; (c) a commit deleting 256 of those edges and 256 base
   edges, after which ``run_incremental`` is the cold run; (d) ``compact``
   and a fresh frozen session on the compacted file, equal to the mutable
   session; (e) ``session.service(max_batch=16)`` answering sssp/bfs from 4
   client threads while ``svc.apply_mutations`` commits three batches of
   1,024 edges, every answer submitted after the last commit equal to a
   cold solo run; (f) a commit in the middle of a pagerank run at prefetch
   depth 2 raises ``ConcurrentMutationError`` and the next run finishes at
   the new epoch; (g) a weighted int8 store of RMAT scale ``SMALL_SCALE``
   (18), mutable: 4,096 weighted inserts, then ``run_incremental("sssp")``
   through B1, through the gather + fold kernel (B2) and through the plain
   version, bitwise equal to each other and to cold runs of each; then the
   same for a weighted float16 store, with its seconds printed.
   ``run_incremental("label_propagation")`` joins (b).  The phase's
   launches must equal the shards its runs processed (B2: the gather +
   fold sssp runs);
9. zoo and baselines — on a warm session: (a) label_propagation and kcore
   (k = 2) through B1, B2 and the plain version, values and
   ``IterationStats`` bitwise equal; (b) ``run_batch`` of lp over the
   first ``ZOO_K`` (8) of phase 5's sources and of kcore over k = 1..8
   through B1, B3 and plain, each column equal to its solo run; (c) a ``triangles`` slab [0, 128) in
   two chunks of 64 (K = 64, three sweeps each) through B1, B3 and plain,
   one engine a config; (d) 16 random walks (length 8, seed 0) on the
   card's session and a ``device="cpu"`` session, both cold: the same
   walks and cache trace, no launch; a solo walk equals its column; (e)
   lp, kcore, triangle_count and random_walk queries from 4 client threads
   to the service, each answer equal to its solo run; (f) ``ESGEngine`` and
   ``PSWEngine`` run bfs and cc at RMAT scale 18 on the card and on the
   CPU, equal in values and bytes read and written, beside a session's
   seconds and disk bytes per iteration (cache mode 0).  Every zoo run is
   capped at ``ZOO_ITERS``.  The phase's launches must equal the shards
   its runs processed.
10. telemetry — on a warm session: (a) the bench's default trace (bfs :
   sssp = 3 : 1, max_iters 32, a 3x burst in the middle third) at half the
   rate phase 5's K = 16 bfs run retires, ``TRACE_SECONDS`` long; (b)
   ``replay_trace`` under phase 5's policy (max_batch 16, max_wait_ms 50,
   two runners) with a ``MetricsHub`` emitting JSONL every 0.5 s; (c) the
   same trace with the ``AdaptiveServeController`` at an SLO of half (b)'s
   p99 and a fresh hub.  Every event completes, the two digests are equal,
   four replayed events equal their solo runs, and each hub's counters
   equal the replay's ``IterationStats``, cache bytes and completions; (d)
   the same mix at RMAT scale ``SMALL_SCALE`` replayed on a cuda session
   with kernels, one with ``use_kernel=False``, a ``device="cpu"`` session
   and ``python -m repro_torch.serve.bench --adaptive --metrics`` in a
   subprocess, all four digests equal; every metrics file passes
   ``python -m repro_torch.obs``.  The phase's launches must equal the
   shards its kernel sessions processed.
11. LLM serving — (a) ``Model(get_config("gemma-2b"))`` at its published
   width in bf16 on the card (weights from ``torch.Generator`` seed 0),
   ``ServeEngine.generate`` on ``LLM_BATCH`` (8) prompts of ``LLM_PROMPT``
   (128) tokens (numpy seed 0), ``LLM_TOKENS`` (32) greedy tokens each:
   prefill seconds, decode tokens/s and ms a step beside the step's bound
   (weight and KV bytes at 3.35 TB/s), peak memory, and a profile of
   ``LLM_PROFILE_STEPS`` decode steps (device ops and busy time a step);
   (b) the same model in float32 at batch 2: the prefill's and 4 decode
   steps' logits against the teacher-forced forward, to ``LLM_F32_ATOL`` +
   ``LLM_F32_RTOL``; (c) every architecture at ``reduced()`` size in
   float32, the same weights on the card and on the CPU: prefill and 4
   decode steps' logits to ``LLM_CARD_CPU_TOL``, 8 greedy tokens equal
   (but after a near tie).  The phase launches no SpMV kernel.
12. LLM training — (a) ``Model(get_config("gemma-2b"))`` at its published
   width and depth in bf16 (``torch.Generator`` seed 0), AdamW with float32
   masters and remat (policy "nothing"), ``TRAIN_STEPS`` (10) steps of B =
   ``TRAIN_BATCH`` (4) x S = ``TRAIN_SEQ`` (512) tokens cycling over two
   ``SyntheticLM`` batches (seed 0): every loss finite and the last below
   the first; the median step time, tokens/s and the share of the step's
   FLOP bound (8 N T with remat at 989 TFLOP/s), ``apply_updates``'s time
   (CUDA events) against its byte bound (float32 m, v and master read and
   written, bf16 grads read, bf16 params written, at 3.35 TB/s), peak
   memory above what earlier phases hold, and a profile of one step
   (device ops, busy ms and share); (b) every architecture at
   ``reduced()`` size in float32, the same weights on the card and on the
   CPU, one AdamW step each, then stablelm-1.6b with Adafactor, with int8
   error feedback and with ``remat_policy="dots"``: the loss, every
   gradient, the grad norm and every parameter after the optimizer step
   (on the CPU's gradients) to ``TRAIN_CARD_CPU_TOL``; (c)
   stablelm-1.6b reduced in bf16, ten steps in one go against five, a
   save, a restore into a fresh state and five more: losses to
   ``TRAIN_RESUME_RTOL``; (d) ``python -m repro_torch.launch.train`` on the
   card, killed with SIGTERM after its first checkpoint and resumed to
   its 40th step, final loss below 7.0.  The phase launches no SpMV kernel.

13. mesh — a mesh's lanes in one process, all on the one card; a mesh
   model holds every weight resident lane by lane (one piece a lane, cut
   by ``param_sharding``) and runs as the reference's SPMD program: (a)
   ``MESH_ARCH`` (kimi-k2-1t-a32b) at its published width, depth cut to
   ``MESH_LAYERS`` (2: its dense first layer and one MoE layer), bf16,
   ``torch.Generator`` seed 0; the forward's logits and aux loss over B =
   ``MESH_BATCH`` (8) x S = ``MESH_SEQ`` (128) tokens (numpy seed 0)
   with no mesh and on a (data 2 x model 2) mesh with expert-parallel
   'a2a', 'replicated' (these two share one copy of the pieces) and the
   serve 2-D layout (its own pieces, drawn from the same seed), one model
   on the card at a time: all finite, no lane's expert piece a view of
   another lane's tensor, the three mesh modes (the same local tokens and
   capacity, 14 slots an expert: tokens dropped) agree to
   ``MESH_BF16_TOL``; ms a forward for each, peak memory above what
   phase 12 leaves, one profiled forward each; (b) the same weights with
   ``long_context`` on (data 4 x model 1): a ``LONG_PROMPT`` (1,024)
   token prefill at batch ``LONG_BATCH`` (4) into a ``LONG_CACHE``
   (1,152) slot cache, then ``LONG_STEPS`` (16) greedy steps through
   ``flash_decode_sharded`` and the same steps with no mesh (the no-mesh
   run's tokens fed to both): logits to ``MESH_BF16_TOL``, greedy tokens
   equal but after a near tie, ms a step for each; (c) every architecture at ``reduced()``
   size in float32 on 2 x 2 lanes, on the card and on the CPU with the
   same weights: forward logits and one ``loss_fn`` backward's gradients
   to ``MESH_CARD_CPU_TOL``, the MoE archs in each EP mode and kimi with
   capacity factor 1.0, gemma-2b's prefill and decode with its KV head
   repeated to 2; (d) ``python -m repro_torch.launch.train --mesh 2x2``
   with the four lanes on the card, ``MESH_CLI_STEPS`` steps, its loss
   falling; (e) phase 12's cell on (data 2 x model 2) lanes: gemma-2b at
   its published width, B = 4 x S = 512, AdamW with float32 masters and
   remat, seed 0, ``MESH_TRAIN_STEPS`` (3) steps on phase 12's batches:
   each step's loss to phase 12's no-mesh loss within ``MESH_TRAIN_RTOL``
   (2e-3), each lane's parameter and optimizer-state bytes (its own
   storages) kept for phase 14; (f) the recurrent blocks tensor parallel
   over 'model' (``REC_MODELS``): xlstm-1.3b at its published width and
   depth and jamba-v0.1-52b at its published width, depth cut to 8 layers
   (one reference unit: 7 Mamba, 1 attention, 4 MoE), bf16, seed 0, its
   MoE capacity factor E / k (no token dropped, so the mesh and no mesh
   route alike), one model on the card at a time, on (data 2 x model 2)
   lanes and with no mesh: a ``REC_PROMPT`` (128) token prefill at batch
   ``REC_BATCH`` (4), then ``REC_STEPS`` (16) greedy steps, the no-mesh
   tokens fed to both: xlstm's logits to ``MESH_BF16_TOL``; jamba's
   (whose bf16 run sits farther from float32 than that bound on its own)
   the same pair in float32 to ``LLM_F32_ATOL`` + ``LLM_F32_RTOL``, and
   its bf16 mesh run no farther from the float32 run than the no-mesh
   bf16 run, plus ``MESH_BF16_TOL``; greedy tokens equal but at a near
   tie; no Mamba, mLSTM or sLSTM weight gathered over
   'model', each lane's Mamba scan on [2, 128, 4096, 16] and ssm state
   part [2, 4096, 16], mLSTM on 2 heads, sLSTM steps on 1,024 channels;
   ms a prefill and a step with and without the mesh, peak memory, within
   ``REC_SECONDS`` (40 s).  The phase launches no SpMV kernel.
14. dry run — ``launch.dryrun.trace_cell`` of phase 12's cell (gemma-2b
   at full width, B = 4 x S = 512, AdamW with float32 masters, remat
   "nothing") on one ``meta`` lane, beside phase 12's real step on the
   card: its FLOPs equal ``FlopCounterMode`` over one more of phase 12's
   steps (the batch as int32, the reference's and the dry run's dtype),
   its argument bytes equal the bytes of the real state and batch, and
   argument + temp bytes within ``DRYRUN_PEAK_RTOL`` (5%) of phase 12's
   measured peak (``torch.cuda.max_memory_allocated`` above what was
   held before the model); then the same cell on (data 2 x model 2)
   ``meta`` lanes, beside phase 13 (e): a lane's parameter and optimizer
   state bytes equal (e)'s lanes' own storages exactly, its temp is a
   number, and its counted all-gather and reduce-scatter bytes equal
   ``derived_collectives``' FSDP rule.  It runs no production-mesh cell
   and no subprocess (a meta trace needs no card), must end within
   ``DRYRUN_SECONDS`` (60 s), and launches no SpMV kernel.
15. examples — the four ``repro_torch.examples`` twins' ``main`` in this
   process, once each on the card: quickstart (RMAT scale 14),
   graph_analytics ``--scale 14``, serve_lm at its defaults (mixtral-8x22b
   reduced) and train_tiny_lm ``--steps 30``, each with its own checks.
   The two graph twins also run with ``--device cpu`` (the plain version)
   first: their exact runs, quickstart's K = 8 landmark batch and every
   ``IterationStats`` bitwise equal, PageRank to ``PR_RTOL``.  B1's
   launches (K = 1 and K = 8) must equal the shards the card's runs
   processed; serve_lm and train_tiny_lm launch no SpMV kernel.  No
   subprocess; the phase must end within ``EXAMPLES_SECONDS`` (45 s).

The last line is ``{"ok": true, "device": {...}}``; any failed phase exits
non-zero before it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
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
SMALL_SCALE = 18               # phase 8 (g)'s stores, phase 9's baselines
ZOO_ITERS = 30                 # phase 9: the cap on every zoo run
ZOO_K = 8                      # phase 9: the lp and kcore batches' columns
TRACE_SECONDS = 8.0            # phase 10: the scale-22 trace's length
SMALL_EVENTS = 32              # phase 10 (d): the trace the cpu session
SMALL_SPEED = 2.0              # replays too (events expected), its speed-up
TILE_WIDTH = 128               # ELL width of the 2-D tiles
BF16_FLOPS = 989e12            # H100 SXM data sheet, dense bf16
LLM_ARCH = "gemma-2b"          # phase 11: served at its published width
LLM_BATCH = 8                  # requests
LLM_PROMPT = 128               # prompt tokens each
LLM_TOKENS = 32                # greedy tokens each
LLM_PROFILE_STEPS = 4          # decode steps under torch.profiler
LLM_F32_BATCH = 2              # (b): the float32 copy's batch
LLM_F32_STEPS = 4              # decode steps after the prefill, compared
# float32 with TF32 off: prefill (a GEMM over the prompt) and decode (one
# row) sum the same products in another order, through 18 layers
LLM_F32_ATOL = 1e-3
LLM_F32_RTOL = 1e-3
# (c): the same reduced model on the card and on the CPU, float32
LLM_CARD_CPU_TOL = 1e-4        # atol and rtol
LLM_MARGIN = 1e-4              # a top-two logit gap below it is a near tie
TRAIN_ARCH = "gemma-2b"        # phase 12: trained at its published width
TRAIN_BATCH = 4                # sequences a step
TRAIN_SEQ = 512                # tokens each
TRAIN_STEPS = 10               # steps, cycling over TRAIN_CYCLE batches
TRAIN_CYCLE = 2
TRAIN_TIMED_FROM = 2           # the median step time over steps 3..10
# tests/test_train.py's optimizer settings (AdamW, fp32 masters for bf16)
TRAIN_OPT = dict(peak_lr=3e-3, warmup_steps=5, decay_steps=200)
TRAIN_CARD_CPU_TOL = 1e-4      # (b): atol and rtol, float32
TRAIN_RESUME_RTOL = 1e-5       # (c): tests/test_train.py's own
TRAIN_KILL_AFTER = 6           # (d): SIGTERM once this step is printed
MESH_ARCH = "kimi-k2-1t-a32b"  # phase 13: at its published width
MESH_LAYERS = 2                # depth cut from 61: the dense layer, one MoE
MESH_BATCH, MESH_SEQ = 8, 128  # (a): T = 1024, T_local = 512 on data = 2
MESH_TIMED = 3                 # (a): forwards timed a mode, after one warm
# bf16: two computations of one forward or decode that round different
# intermediates (the EP modes' combine and split ff sums; one softmax a
# lane against one over the cache, so every attention probability rounds
# to bf16 another way).  Each stays within about 0.05 of the float32
# computation on the same bf16 weights at |logits| up to about 4 (the
# CPU, widths 64 to 2,048); two of them within twice that, plus a bf16
# ulp of the logit
MESH_BF16_TOL = dict(atol=0.125, rtol=2 ** -7)
# (b): prefill, then LONG_STEPS greedy steps; the batch splits over the
# 4 data lanes, the cache's 1152 slots too (288 a lane)
LONG_BATCH, LONG_PROMPT = 4, 1024
LONG_CACHE, LONG_STEPS = 1152, 16
MESH_CARD_CPU_TOL = 1e-4       # (c): atol and rtol, float32 (phase 12's)
MESH_CLI_STEPS = 8             # (d)
MESH_TRAIN_STEPS = 3           # (e): phase 12's first steps on 2 x 2 lanes
MESH_TRAIN_RTOL = 2e-3         # (e): the bf16 trajectory bound of the CLI
# (f): the recurrent blocks tensor parallel over 'model', at full width:
# (arch, depth or None for the published one, whether a float32 pair
# holds the logits).  jamba's MoE capacity factor is E / k, so no expert
# drops a token (a drop depends on the tokens a data lane holds, so the
# mesh and no mesh would drop different ones).  jamba's bf16 run with no
# mesh sits up to 0.81 from float32 on its own weights (an H100 80GB HBM3
# at 700 W: a rounding moves a token to another expert, and 8 layers
# carry it), past MESH_BF16_TOL itself, so its bf16 pair cannot be held
# to it: its
# float32 pair is held to LLM_F32_ATOL + LLM_F32_RTOL, and its bf16 mesh
# run to no farther from that float32 run than the no-mesh bf16 run is,
# plus MESH_BF16_TOL
REC_MODELS = (("xlstm-1.3b", None, False), ("jamba-v0.1-52b", 8, True))
REC_BATCH, REC_PROMPT, REC_STEPS = 4, 128, 16
REC_SECONDS = 40.0             # (f)'s budget
# phase 14: the dry run's argument + temp bytes on one meta lane against
# phase 12's measured peak (the caching allocator rounds each block up, and
# the peak holds a second batch); and its time budget
DRYRUN_PEAK_RTOL = 0.05
DRYRUN_SECONDS = 60.0
EXAMPLES_SECONDS = 45.0        # phase 15's budget, its CPU runs included


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
    for the host arrays phases 3 and 7 lay the same edges out in:
    ``layouts["tiles"]`` (``tile_ells``), built while the store is
    preprocessed, and ``layouts["mesh"][D]`` (``partition_for_mesh`` at D
    = 1 and LANES), built after it, beside phases 3 to 6; each as
    ``(result, seconds)``."""
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
    layouts = dict(tiles=pool.submit(_timed, tile_ells, src, dst, n))
    t1 = time.perf_counter()
    store = preprocess_graph(str(tmp / "edges"), str(tmp / "store"))
    t2 = time.perf_counter()
    # phase 7's partitions, off the cores preprocessing keeps busy
    layouts["mesh"] = {D: pool.submit(_timed, partition_for_mesh, src, dst,
                                      n, D) for D in (LANES, 1)}
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
    the host, a thread a tile).  The edges are first put in destination
    order once (stably, by two 16-bit radix passes), so each tile's share
    arrives sorted and its stable sort by destination finds nothing to
    move: the same tiles.  The blocks are ``ceil(n / LANES)`` long, so the
    last one may reach past n.  -> {(d, s): ELLShard}."""
    import numpy as np

    from repro_torch.core.shards import build_csr_shards, csr_to_ell

    check(n <= 1 << 32, f"{n} vertices: more than two 16-bit digits")
    order = np.argsort((dst & 0xFFFF).astype(np.uint16), kind="stable")
    order = order[np.argsort((dst[order] >> 16).astype(np.uint16),
                             kind="stable")]
    src, dst = src[order], dst[order]
    del order
    per = vb = -(-n // LANES)
    into = dst // per
    frm = src // vb

    def tile(key):
        d, s = key
        m = (into == d) & (frm == s)
        csr = build_csr_shards(src[m] - s * vb, dst[m] - d * per, per,
                               threshold_edge_num=1 << 62)[0]
        ell = csr_to_ell(csr, max_width=TILE_WIDTH)
        check(ell.shape[1] == TILE_WIDTH, f"tile width {ell.shape[1]}")
        return ell
    keys = [(d, s) for d in range(LANES) for s in range(LANES)]
    with ThreadPoolExecutor(max_workers=len(keys),
                            thread_name_prefix="tiles") as pool:
        return dict(zip(keys, pool.map(tile, keys)))


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
    shard), averaged over ``reps`` passes after two warm-up passes; a pass
    slower than 0.1 s (a plain batched version) has one warm-up pass and
    about a second of timed ones, two at least.

    ``device_ms`` sums the durations of the device activities the passes
    ran (kernels, copies, memsets), from torch.profiler: the kernel's own
    time.  ``events_ms`` is CUDA events around the passes, which also counts
    the gaps in which the card waited for the host to launch the next
    kernel — at ~35 us a kernel, the host's launch overhead shows there."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    for c in calls:
        c()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if first < 0.1:
        for c in calls:
            c()
        torch.cuda.synchronize()
    else:
        reps = max(2, min(reps, int(1.0 / first) + 1))
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
    launch counts of the run_batch phase, ``(sources, the fused sssp
    columns)`` for phase 7 and the fused K = 16 bfs run's seconds for
    phase 10."""
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
        launches, cols, bfs_seconds = run_batch_path(torch, s, sources,
                                                     solo)
        profile_run(torch, f"bfs K={BATCH_K}",
                    lambda: (s.run_batch("bfs", sources=sources),
                             s.last_batch_result)[1])
        run_service(torch, s, sources, cols)
    return launches, (sources, cols["sssp"]), bfs_seconds


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
    return (launches, {app: cols["fused", app] for app, _ in runs},
            results["fused", "bfs"].total_seconds)


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
    log(f"multi: partition_for_mesh built on the host (beside phases 3 "
        f"to 6) in {took}; [D, R, W] = "
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


# --------------------------------------------------------------------------
def phase_storage(torch, store_path: str, solo, sources) -> dict:
    """Phase 8: the packed and memory backends and the mutable graph on the
    card.  ``solo`` holds phase 4's results by (variant, app), ``sources``
    phase 5's.  Returns the phase's launch counts (set to 0 at its start)."""
    import numpy as np

    from repro_torch.graph.packed import pack_graph
    from repro_torch.graph.storage import GraphStore
    from repro_torch.kernels.spmv import cuda

    cuda.reset_launches()
    # shards processed by runs through each kernel, from IterationStats:
    # "fold" while the gather + fold run is on, "fused" otherwise (K = 1
    # and the service's batches, which launch either fused kernel)
    shards = {"fused": 0, "fold": 0, "none": 0}
    kernel = ["fused"]
    lock = threading.Lock()  # the service's runners sweep concurrently

    def observe(st):
        with lock:
            shards[kernel[0]] += st.shards_processed

    t0 = time.perf_counter()
    packed = pack_graph(GraphStore(store_path))
    log(f"storage: pack_graph wrote {packed.stat().st_size} bytes in "
        f"{time.perf_counter() - t0:.1f}s")
    storage_backends(store_path, packed, solo, observe)
    mutable_graph(packed, sources, observe, shards, kernel)
    for dtype in ("int8", "float16"):
        quantized_mutation(Path(store_path).parent, observe, kernel, dtype)
    launches = dict(cuda.launches)
    fused = launches["ell_spmv_fused"] + launches["ell_spmv_fused_batch"]
    check(fused == shards["fused"] > 0
          and launches["ell_fold"] == shards["fold"] > 0
          and launches["ell_spmv_fused_batch"] > 0
          and launches["ell_fold_batch"] == 0,
          f"storage: launches {launches}, expected {shards['fused']} fused "
          f"(some batched) and {shards['fold']} fold")
    log(f"storage: all checks passed; launches {launches}")
    return launches


def _equal_runs(np, got, want, what: str) -> None:
    """``got`` equals ``want``: iterations and shards processed, values
    bitwise (PageRank to PR_RTOL)."""
    check(got.iterations == want.iterations,
          f"{what}: {got.iterations} iterations, expected {want.iterations}")
    check(sum(h.shards_processed for h in got.history)
          == sum(h.shards_processed for h in want.history),
          f"{what}: shards processed differ")
    if got.tag.startswith("pagerank"):
        rel = _max_rel_err(np, got.values, want.values)
        check(rel <= PR_RTOL, f"{what}: off by {rel} (rtol {PR_RTOL})")
    else:
        check(np.array_equal(got.values, want.values),
              f"{what}: values differ")


def _run_line(label: str, r, other=None) -> str:
    fetch = sum(h.fetch_seconds for h in r.history)
    line = (f"{label} iterations={r.iterations} "
            f"shards={sum(h.shards_processed for h in r.history)} "
            f"seconds={r.total_seconds:.3f} fetch_s={fetch:.3f} "
            f"disk_bytes={sum(h.disk_bytes for h in r.history)}")
    if other is not None:
        line += (f" | {other[0]} iterations={other[1].iterations} "
                 f"shards={sum(h.shards_processed for h in other[1].history)}"
                 f" seconds={other[1].total_seconds:.3f} fetch_s="
                 f"{sum(h.fetch_seconds for h in other[1].history):.3f}")
    return line


def storage_backends(store_path: str, packed, solo, observe) -> None:
    """(a) The four apps on ``backend="packed"`` and bfs/sssp on
    ``backend="memory"``, against phase 4's npz runs."""
    import numpy as np

    from repro_torch.session import GraphSession

    runs = [("pagerank", dict(max_iters=10)), ("sssp", dict(source=0)),
            ("bfs", dict(source=0)), ("cc", {})]
    with GraphSession(store_path, backend="packed", cache_mode=1,
                      cache_budget_bytes=CACHE_BUDGET) as s:
        check(type(s.store).__name__ == "PackedGraphStore",
              f"backend='packed' opened a {type(s.store).__name__}")
        s.iteration_observers.append(observe)
        for app, kw in runs:  # phase 4's order: the first app reads cold
            r, want = s.run(app, **kw), solo["fused", app]
            log(_run_line(f"storage: packed {app:8s}", r, ("npz", want)))
            _equal_runs(np, r, want, f"packed {app}")
            check(sum(h.disk_bytes for h in r.history)
                  == sum(h.disk_bytes for h in want.history),
                  f"packed {app}: disk bytes differ from phase 4's")
        store = s.store
    check(store._mm.closed, "session.close() left the packed mmap open")
    t0 = time.perf_counter()
    with GraphSession(str(packed), backend="memory", cache_mode=1,
                      cache_budget_bytes=CACHE_BUDGET) as s:
        log(f"storage: memory backend loaded from the packed file in "
            f"{time.perf_counter() - t0:.1f}s")
        s.warm()  # as phase 4's later apps: every shard already cached
        s.iteration_observers.append(observe)
        for app, kw in runs[2:0:-1]:
            r, want = s.run(app, **kw), solo["fused", app]
            log(_run_line(f"storage: memory {app:8s}", r, ("npz", want)))
            _equal_runs(np, r, want, f"memory {app}")
            check(sum(h.disk_bytes for h in r.history) == 0,
                  f"memory {app}: disk bytes after warm()")


def _new_edges(np, s, rng, count: int, targets) -> tuple:
    """``count`` edges absent from the graph: sources uniform over the
    vertices with out-edges, destinations uniform over the intervals of the
    shards ``targets``."""
    n = s.n
    iv = s.store.intervals
    pool = np.concatenate([np.arange(iv[p], iv[p + 1]) for p in targets])
    have = []
    for p in targets:
        shard = s.store.read_shard(p)
        r, c = np.nonzero(shard.cols >= 0)
        have.append((shard.row_map[r].astype(np.int64) + shard.start_vertex)
                    * n + shard.cols[r, c])
        del shard
    have = np.concatenate(have)
    cand = np.nonzero(s.out_deg > 0)[0]
    src = cand[rng.integers(0, cand.size, 2 * count)].astype(np.int64)
    dst = pool[rng.integers(0, pool.size, 2 * count)].astype(np.int64)
    keys = dst * n + src
    ok = (src != dst) & ~np.isin(keys, have)
    _, first = np.unique(keys, return_index=True)
    keep = np.zeros(keys.size, dtype=bool)
    keep[first] = True
    sel = np.nonzero(ok & keep)[0][:count]
    check(sel.size == count, f"drew {sel.size} new edges, wanted {count}")
    return src[sel], dst[sel]


def mutable_graph(packed, sources, observe, shards, kernel) -> None:
    """(b)-(f): incremental runs after a monotone commit, a delete that
    forces the cold fallback, compaction, the service under mutation and a
    commit in the middle of a prefetching run."""
    import numpy as np

    from repro_torch.graph.compact import compact
    from repro_torch.graph.source import ConcurrentMutationError
    from repro_torch.kernels.spmv import cuda
    from repro_torch.session import GraphSession

    apps = [("sssp", dict(source=0)), ("bfs", dict(source=0)), ("cc", {})]
    # label propagation (phase 9's, run here on the mutated graph): labels
    # only grow, so its fixpoint continues across the inserts too
    incremental = apps + [("label_propagation", {})]
    s = GraphSession(str(packed), mutable=True, cache_mode=1,
                     cache_budget_bytes=CACHE_BUDGET)
    try:
        s.iteration_observers.append(observe)
        prev = {app: s.run(app, **kw) for app, kw in incremental}
        # (b) a burst of 4,096 new unit-weight links into 4 shards
        rng = np.random.default_rng(2)
        targets = sorted(int(p) for p in rng.choice(s.store.num_shards, 4,
                                                    replace=False))
        ins = _new_edges(np, s, rng, 4096, targets)
        t0 = time.perf_counter()
        epoch = s.apply_mutations(inserts=ins)
        check(epoch == 1 and s.store.dirty_shards() == targets,
              f"commit: epoch {epoch}, dirty {s.store.dirty_shards()}")
        log(f"mutable: committed 4096 inserts into shards {targets} in "
            f"{time.perf_counter() - t0:.1f}s; n_pad={s.n_pad}")
        before = dict(cuda.launches)
        processed = shards["fused"]
        cold = {}
        for app, kw in incremental:
            inc = s.run_incremental(app, prev=prev[app], **kw)
            cold[app] = s.run(app, **kw)
            log(_run_line(f"mutable: incremental {app:4s}", inc,
                          ("cold", cold[app])))
            check(np.array_equal(inc.values, cold[app].values)
                  and inc.epoch == cold[app].epoch == 1,
                  f"incremental {app} differs from a cold run")
            check(sum(h.shards_processed for h in inc.history)
                  <= sum(h.shards_processed for h in cold[app].history)
                  and inc.iterations <= cold[app].iterations,
                  f"incremental {app} swept more than a cold run")
        check(cuda.launches["ell_spmv_fused"] - before["ell_spmv_fused"]
              == shards["fused"] - processed,
              "incremental and cold runs: B1 launches differ from the "
              "shards they processed")
        kernel[0] = "fold"
        r = s.run("sssp", source=0,
                  config=s.config.replace(fused_gather=False))
        kernel[0] = "fused"
        check(np.array_equal(r.values, cold["sssp"].values),
              "sssp through gather + fold differs on the merged shards")
        # (c) deletes: 256 of the new edges and 256 base edges of the same
        # shards, so the commit is not monotone
        base = []
        for p in targets:
            shard = s.store.base.read_shard(p)
            rr, cc = np.nonzero(shard.cols >= 0)
            pick = rng.choice(rr.size, 64, replace=False)
            base.append((shard.cols[rr[pick], cc[pick]].astype(np.int64),
                         shard.row_map[rr[pick]].astype(np.int64)
                         + shard.start_vertex))
            del shard
        dels = (np.concatenate([ins[0][:256]] + [b[0] for b in base]),
                np.concatenate([ins[1][:256]] + [b[1] for b in base]))
        s.apply_mutations(deletes=dels)
        check(not s.store.monotone_since(1), "a delete left the log monotone")
        final = {}
        for app, kw in apps:
            inc = s.run_incremental(app, prev=cold[app], **kw)
            final[app] = s.run(app, **kw)
            log(_run_line(f"mutable: after delete {app:4s}", inc,
                          ("cold", final[app])))
            check(inc.iterations == final[app].iterations
                  and np.array_equal(inc.values, final[app].values),
                  f"{app} after a delete: run_incremental is not the cold "
                  "fallback")
        # (d) compaction, then a fresh frozen session on the file
        rep = compact(s.store)
        log(f"mutable: compact rewrote shards {list(rep.shards_rewritten)}: "
            f"{rep.bytes_written} bytes written, {rep.dead_bytes} dead, "
            f"{rep.seconds:.1f}s")
        check(list(rep.shards_rewritten) == targets
              and not s.store.dirty_shards(), "compaction left dirty shards")
        with GraphSession(str(packed), cache_mode=1,
                          cache_budget_bytes=CACHE_BUDGET) as fresh:
            fresh.iteration_observers.append(observe)
            for app, kw in apps:
                r = fresh.run(app, **kw)
                check(np.array_equal(r.values, final[app].values),
                      f"{app} on the compacted file differs from the "
                      "mutable session")
        log("mutable: the compacted file gives the mutable session's "
            "sssp/bfs/cc")
        # (e) and (f)
        mutated_service(np, s, sources, targets, rng)
        # (its runs add to shards["fused"] while it runs)
        torn = mid_run_commit(s, rng, targets, ConcurrentMutationError)
        shards["fused"] += torn
    finally:
        s.close()
    check(s.store.base._mm.closed,
          "session.close() left the mutable session's mmap open")


def mutated_service(np, s, sources, targets, rng) -> None:
    """(e) 4 client threads query sssp/bfs while three insert batches of
    1,024 edges commit through ``svc.apply_mutations``."""
    during, after = sources[:2], sources[2:4]
    errors, answers = [], []  # answers: (app, source, result) of queries
    #                           submitted after the last commit returned
    stop, started, last = threading.Event(), threading.Barrier(5), [None]
    rounds_after = [0] * 4  # each client's rounds begun after it

    def client(c):
        try:
            first = True
            while not stop.is_set():
                t = time.perf_counter()
                v = during[c % 2]
                futs = [(app, v, svc.submit(app, source=v))
                        for app in ("sssp", "bfs")]
                for app, v, f in futs:
                    r = f.result(timeout=600)
                    if last[0] is not None and t > last[0]:
                        answers.append((app, v, r))
                if last[0] is not None and t > last[0]:
                    rounds_after[c] += 1
                if first:
                    first = False
                    started.wait(timeout=600)
                time.sleep(0.01)
        except BaseException as exc:  # noqa: BLE001 — checked below
            errors.append(exc)

    reports = []
    with s.service(max_batch=BATCH_K) as svc:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        started.wait(timeout=600)  # every client has had one answer
        for i in range(3):
            ins = _new_edges(np, s, rng, 1024, targets)
            reports.append(svc.apply_mutations(inserts=ins))
        last[0] = time.perf_counter()
        # every client completes rounds begun at the final epoch
        deadline = time.perf_counter() + 600
        while min(rounds_after) < 2 and not errors \
                and time.perf_counter() < deadline:
            time.sleep(0.05)
        stop.set()
        for t in threads:
            t.join(timeout=600)
        # queries nobody asked before: coalesced sweeps at the final epoch
        futs = [(app, v, svc.submit(app, source=v))
                for v in after for app in ("sssp", "bfs")]
        answers += [(app, v, f.result(timeout=600)) for app, v, f in futs]
        wall = time.perf_counter() - t0
        snap = svc.stats.snapshot()
    check(not errors and not any(t.is_alive() for t in threads),
          f"service clients failed: {errors}")
    check(snap["failed"] == 0, f"service: {snap['failed']} requests failed")
    epoch = s.store.epoch()
    check([r.epoch for r in reports] == [epoch - 2, epoch - 1, epoch],
          f"service commits reached epochs {[r.epoch for r in reports]}")
    want = {}
    for app, v, r in answers:
        if (app, v) not in want:
            want[app, v] = s.run(app, source=v).values
        check(np.array_equal(r.values, want[app, v]),
              f"service {app} source {v} after the last commit differs "
              "from a cold solo run")
    log(f"service: {snap['completed']} queries from 4 threads across 3 "
        f"commits in {wall:.3f}s; memo_refreshed="
        f"{[r.memo_refreshed for r in reports]} memo_dropped="
        f"{[r.memo_dropped for r in reports]} memo_hits={snap['memo_hits']} "
        f"batch_occupancy={snap['batch_occupancy']}; {len(answers)} answers "
        f"after the last commit equal {len(want)} cold solo runs")


def mid_run_commit(s, rng, targets, error) -> int:
    """(f) A commit while a pagerank run streams at prefetch depth 2 must
    raise ``error``; the next run finishes at the new epoch.  Returns the
    launches of the torn sweep (no IterationStats counts them): one a shard
    it folded before it reached the committed one."""
    import numpy as np

    from repro_torch.kernels.spmv import cuda

    cfg = s.config.replace(prefetch_depth=2)
    gen = s.iter_run("pagerank", max_iters=3, config=cfg)
    next(gen)
    edge = _new_edges(np, s, rng, 1, targets)
    dirty = int(np.searchsorted(s.store.intervals, edge[1][0],
                                side="right") - 1)
    s.store.apply(inserts=edge)
    before = cuda.launches["ell_spmv_fused"]
    try:
        for _ in gen:
            pass
    except error as exc:
        log(f"mutable: mid-run commit raised {type(exc).__name__}: {exc}")
    else:
        raise Failed("a commit during a prefetching run did not raise")
    torn = cuda.launches["ell_spmv_fused"] - before
    check(torn == dirty, f"the torn sweep launched B1 {torn} times, "
                         f"expected one a shard before shard {dirty}")
    r = s.run("pagerank", max_iters=2, config=cfg)
    check(r.epoch == s.store.epoch() and np.isfinite(r.values).all(),
          f"the run after a mid-run commit pinned epoch {r.epoch}, not "
          f"{s.store.epoch()}")
    log(f"mutable: the next pagerank run finished at epoch {r.epoch}")
    return torn


@functools.cache
def small_rmat():
    """-> (src, dst, n): the RMAT edges of phase 8's int8 store and phase
    9's baselines, at SMALL_SCALE (a, b, c = .57, .19, .19, seed 0)."""
    from repro_torch.graph.generate import materialize, rmat_edges

    src, dst = materialize(rmat_edges(SMALL_SCALE, 16, a=0.57, b=0.19,
                                      c=0.19, seed=0))
    return src, dst, int(max(src.max(), dst.max())) + 1


def small_store(tmp: Path, name: str, weighted: bool = False,
                **preprocess) -> str:
    """``small_rmat``'s edges (with random weights in [1, 10) when
    ``weighted``) preprocessed into ``tmp / name``."""
    from repro_torch.graph.preprocess import preprocess_graph
    from repro_torch.graph.storage import write_edge_list

    src, dst, _ = small_rmat()
    write_edge_list(tmp / f"{name}_edges", [(src, dst)], weighted=weighted,
                    seed=1)
    preprocess_graph(str(tmp / f"{name}_edges"), str(tmp / name),
                     **preprocess)
    shutil.rmtree(tmp / f"{name}_edges")
    return str(tmp / name)


def quantized_mutation(tmp: Path, observe, kernel, dtype: str) -> None:
    """(g) A weighted store of ``dtype`` edges (int8, float16) at
    SMALL_SCALE, mutable: a monotone commit of 4,096 weighted inserts, then
    ``run_incremental("sssp")`` through B1, through the gather + fold route
    (B2) and through the plain version on the card, bitwise equal to each
    other and to cold runs of each; its seconds are printed."""
    import numpy as np

    from repro_torch.session import GraphSession

    t0 = time.perf_counter()
    path = small_store(tmp, f"{dtype}_store", weighted=True, val_dtype=dtype,
                       threshold_edge_num=1 << SMALL_SCALE)
    log(f"quantized: {dtype}: weighted RMAT scale {SMALL_SCALE} preprocessed "
        f"in {time.perf_counter() - t0:.1f}s")
    with GraphSession(path, mutable=True, cache_mode=1,
                      cache_budget_bytes=CACHE_BUDGET) as s:
        check(s.store.properties.get("val_dtype") == dtype,
              f"the store's edges are {s.store.properties.get('val_dtype')}, "
              f"not {dtype}")
        s.iteration_observers.append(observe)
        # the counter each route's shards go to (see phase_storage)
        routes = {"fused": s.config,
                  "fold": s.config.replace(fused_gather=False),
                  "none": s.config.replace(use_kernel=False)}

        def sssp(route, run, **kw):
            kernel[0] = route
            try:
                return run("sssp", source=0, config=routes[route], **kw)
            finally:
                kernel[0] = "fused"

        prev = {r: sssp(r, s.run) for r in routes}
        for r in ("fold", "none"):
            check(np.array_equal(prev["fused"].values, prev[r].values),
                  f"{dtype} sssp through {r} differs from B1 before the "
                  "commit")
        rng = np.random.default_rng(3)
        targets = sorted(int(p) for p in rng.choice(s.store.num_shards, 4,
                                                    replace=False))
        src, dst = _new_edges(np, s, rng, 4096, targets)
        w = (rng.random(src.size) * 9 + 1).astype(np.float32)
        s.apply_mutations(inserts=(src, dst, w))
        inc = {r: sssp(r, s.run_incremental, prev=prev[r]) for r in routes}
        cold = {r: sssp(r, s.run) for r in routes}
    seconds = time.perf_counter() - t0
    log(_run_line(f"quantized: {dtype} incremental sssp", inc["fused"],
                  ("cold", cold["fused"])))
    for runs, what in ((inc, "incremental"), (cold, "cold")):
        for r, got in runs.items():
            check(np.array_equal(inc["fused"].values, got.values),
                  f"{dtype} incremental sssp through B1 differs from the "
                  f"{what} run through {r}")
    check(len({r.iterations for r in inc.values()}) == 1
          and inc["fused"].iterations <= cold["fused"].iterations
          and np.isfinite(inc["fused"].values).sum() > 1,
          f"{dtype} incremental sssp: iterations "
          f"{[r.iterations for r in inc.values()]}, cold "
          f"{cold['fused'].iterations}")
    log(f"quantized: {dtype}: run_incremental sssp after 4096 weighted "
        f"inserts into shards {targets} through B1, B2 and the plain version "
        f"equals cold runs of each bitwise; "
        f"{int(np.isfinite(inc['fused'].values).sum())} vertices reached; "
        f"{seconds:.1f}s")


# --------------------------------------------------------------------------
EXACT_FIELDS = ("iteration", "active_ratio", "shards_processed",
                "shards_skipped", "disk_bytes", "cache_hit_ratio",
                "selective_enabled", "edges_processed")


def _stats(r) -> list:
    return [tuple(getattr(h, f) for f in EXACT_FIELDS) for h in r.history]


def _kernel_of(cfg, k: int):
    """The counter a run's shards launch under (None: the plain version)."""
    if cfg.use_kernel is False:
        return None
    name = "ell_spmv_fused" if cfg.fused_gather else "ell_fold"
    return name if k == 1 else f"{name}_batch"


def phase_zoo(torch, store_path: str, sources, tmp: Path) -> dict:
    """Phase 9: the app zoo and the baselines.  ``sources`` are phase 5's.
    Returns the phase's launch counts (set to 0 at its start)."""
    import numpy as np

    from repro_torch.kernels.spmv import cuda
    from repro_torch.session import GraphSession

    cuda.reset_launches()
    expect = dict.fromkeys(cuda.launches, 0)

    def count(cfg, k, r):
        name = _kernel_of(cfg, k)
        if name is not None:
            expect[name] += sum(h.shards_processed for h in r.history)

    with GraphSession(store_path, cache_mode=1,
                      cache_budget_bytes=CACHE_BUDGET) as s:
        t0 = time.perf_counter()
        s.warm()
        log(f"zoo: cache warmed in {time.perf_counter() - t0:.1f}s; every "
            f"zoo run capped at max_iters={ZOO_ITERS}")
        base = s.config
        variants = {"fused": base,
                    "gather+fold": base.replace(fused_gather=False),
                    "plain": base.replace(use_kernel=False)}
        zoo_solo(s, variants, count)
        solo = zoo_batches(s, variants, sources, count)
        zoo_triangles(s, variants, count)
        walks = zoo_walks(store_path, s, sources)
        svc_shards = zoo_service(s, sources, solo, walks, count)
    baselines(tmp, count)
    launches = dict(cuda.launches)
    fused = expect["ell_spmv_fused"] + expect["ell_spmv_fused_batch"]
    check(launches["ell_spmv_fused"] + launches["ell_spmv_fused_batch"]
          == fused + svc_shards
          and launches["ell_spmv_fused_batch"] >= expect[
              "ell_spmv_fused_batch"] > 0
          and launches["ell_fold"] == expect["ell_fold"] > 0
          and launches["ell_fold_batch"] == expect["ell_fold_batch"] > 0
          and launches["ell_gather_fold"] == 0,
          f"zoo: launches {launches}, expected {expect} plus {svc_shards} "
          "fused in the service")
    log(f"zoo: launches {launches} equal the shards the runs processed")
    return launches


def zoo_solo(s, variants, count) -> None:
    """(a) label_propagation and kcore (k = 2) through B1, B2 and the plain
    version: values and IterationStats bitwise equal."""
    import numpy as np

    for app, kw in (("label_propagation", {}), ("kcore", dict(k=2))):
        runs = {}
        for variant, cfg in variants.items():
            r = s.run(app, config=cfg, max_iters=ZOO_ITERS, **kw)
            count(cfg, 1, r)
            runs[variant] = r
            log(_run_line(f"zoo: {variant:11s} {app:17s}", r)
                + f" converged={r.converged}")
            check(r.values.shape == (s.n,) and np.isfinite(r.values).all(),
                  f"{variant} {app}: bad values")
        want = runs["plain"]
        for variant in ("fused", "gather+fold"):
            check(np.array_equal(runs[variant].values, want.values)
                  and _stats(runs[variant]) == _stats(want),
                  f"{app} {variant} differs from the plain run (values or "
                  "IterationStats)")
        live = (want.values > 0).sum() if app == "kcore" else len(
            np.unique(want.values))
        log(f"zoo: {app} through B1, B2 and plain bitwise equal; "
            f"{'alive' if app == 'kcore' else 'distinct labels'} {live}")


def zoo_batches(s, variants, sources, count) -> dict:
    """(b) lp_multi over the first ``ZOO_K`` of phase 5's sources and
    kcore_multi over k = 1..ZOO_K through B1, B3 and plain; each column
    equals its solo run.  Returns the solo results by (app, source or
    k)."""
    import numpy as np

    solo = {}
    for app, values in (("lp", sources[:ZOO_K]),
                        ("kcore", list(range(1, ZOO_K + 1)))):
        results = {}
        for variant, cfg in variants.items():
            t0 = time.perf_counter()
            s.run_batch(app, sources=values, config=cfg, max_iters=ZOO_ITERS)
            r = s.last_batch_result
            count(cfg, len(values), r)
            results[variant] = r
            fetch = sum(h.fetch_seconds for h in r.history)
            log(f"zoo: {variant:11s} {app:5s} K={r.num_columns} "
                f"iterations={r.iterations} "
                f"column_iterations={r.column_iterations.tolist()} "
                f"seconds={r.total_seconds:.3f} "
                f"wall_s={time.perf_counter() - t0:.3f} "
                f"shards={sum(h.shards_processed for h in r.history)} "
                f"fetch_s={fetch:.3f}")
        want = results["plain"]
        for variant in ("fused", "gather+fold"):
            r = results[variant]
            check(np.array_equal(r.values, want.values)
                  and np.array_equal(r.column_iterations,
                                     want.column_iterations)
                  and _stats(r) == _stats(want),
                  f"{app} K={ZOO_K} {variant} differs from the plain run")
        batch = results["fused"]
        t0 = time.perf_counter()
        seconds = 0.0
        for k, v in enumerate(values):
            if app == "kcore":
                r = s.run("kcore", k=v, max_iters=ZOO_ITERS)
                count(s.config, 1, r)
            else:
                r = s.run_batch("lp", sources=[v], max_iters=ZOO_ITERS)[0]
                count(s.config, 1, s.last_batch_result)
            seconds += r.total_seconds
            solo[app, v] = r
            check(np.array_equal(batch.values[:, k], r.values)
                  and int(batch.column_iterations[k]) == r.iterations,
                  f"{app} column {k} ({v}) differs from its solo run")
        log(f"zoo: {app} K={ZOO_K} fused {batch.total_seconds:.3f}s; "
            f"{ZOO_K} solo runs {seconds:.3f}s (wall "
            f"{time.perf_counter() - t0:.1f}s), each equal to its column")
    return solo


def zoo_triangles(s, variants, count) -> None:
    """(c) A triangle slab [0, 128) in chunks of 64: two K = 64 runs of
    triangles_multi, three sweeps each, on one engine a config."""
    import numpy as np

    runs = {}
    for variant, cfg in variants.items():
        t0 = time.perf_counter()
        r = s.run("triangles", lo=0, hi=128, chunk=64, config=cfg)
        count(cfg, 64, r)
        runs[variant] = r
        log(_run_line(f"zoo: {variant:11s} triangles [0, 128)", r)
            + f" wall_s={time.perf_counter() - t0:.3f}")
        check(r.iterations == 6, f"triangles {variant}: {r.iterations} "
                                 "sweeps, expected 2 chunks of 3")
    engines = [k for k in s._engines if k[0] == ("sig", ("triangles_multi",
                                                          64))]
    check(len(engines) == len(variants),
          f"{len(engines)} [n, 64] triangle engines for {len(variants)} "
          "configs")
    want = runs["plain"]
    for variant in ("fused", "gather+fold"):
        check(np.array_equal(runs[variant].values, want.values)
              and _stats(runs[variant]) == _stats(want),
              f"triangles {variant} differs from the plain run")
    # on a directed graph with self-loops a count is half the closed
    # walks u -> v -> w -> u through u: a multiple of 0.5
    counts = want.values[:128]
    check(np.array_equal(2 * counts, np.round(2 * counts))
          and counts.sum() > 0 and not want.values[128:].any(),
          "triangle counts are not multiples of 0.5 on the slab alone")
    log(f"zoo: triangles through B1, B3 and plain at K=64 bitwise equal; "
        f"counts on [0, 128) sum to {counts.sum()}, max {counts.max()}")


def zoo_walks(store_path, s, sources) -> dict:
    """(d) 16 random walks (length 8, seed 0) on the card's session and on
    a ``device="cpu"`` session over the same store, both from a cold cache:
    the same walks and the same cache trace, no kernel launched; a solo
    walk equals its column.  Returns the card's columns by source."""
    import numpy as np

    from repro_torch.kernels.spmv import cuda
    from repro_torch.session import GraphSession

    out = {}
    for device in ("cuda", "cpu"):
        with GraphSession(store_path, device=device, cache_mode=1,
                          cache_budget_bytes=CACHE_BUDGET) as w:
            before = dict(cuda.launches)
            t0 = time.perf_counter()
            cols = w.run_batch("random_walk", sources=sources, length=8,
                               seed=0)
            r = w.last_batch_result
            check(cuda.launches == before, "random walks launched a kernel")
            trace = [(h.shards_processed, h.disk_bytes, h.cache_hit_ratio,
                      h.edges_processed) for h in r.history]
            out[device] = (r, trace, cols)
            log(f"zoo: random_walks on a {device} session: K=16 steps="
                f"{r.column_iterations.tolist()} "
                f"cache_gets={sum(t[0] for t in trace)} "
                f"disk_bytes={sum(t[1] for t in trace)} "
                f"wall_s={time.perf_counter() - t0:.3f}")
    (g, g_trace, cols), (c, c_trace, _) = out["cuda"], out["cpu"]
    check(np.array_equal(g.values, c.values)
          and np.array_equal(g.column_iterations, c.column_iterations)
          and g_trace == c_trace,
          "random walks on the card's session differ from the CPU's")
    one = s.run_batch("random_walk", sources=[sources[3]], length=8,
                      seed=0)[0]
    check(np.array_equal(one.values, cols[3].values),
          "a solo walk differs from its column")
    log("zoo: random walks equal on the cuda and cpu sessions (values, "
        "steps, cache trace); the solo walk equals its column")
    return {v: col for v, col in zip(sources, cols)}


def zoo_service(s, sources, solo, walks, count) -> int:
    """(e) lp, kcore, triangle_count and random_walk queries from 4 client
    threads to ``s.service(max_batch=16)``; every answer equals its solo
    run.  Returns the shards the service's sweeps processed."""
    import numpy as np

    tri = [0, 1, 2, 3]
    queries = ([("lp", dict(source=v)) for v in sources[:ZOO_K]]
               + [("kcore", dict(k=k)) for k in range(1, ZOO_K + 1)]
               + [("triangle_count", dict(vertex=v)) for v in tri]
               + [("random_walk", dict(source=v, length=8, seed=0))
                  for v in sources])
    want = {}
    for v in tri:
        want["triangle_count", v] = s.run_batch("triangle_count",
                                                sources=[v])[0]
        count(s.config, 1, s.last_batch_result)
    shards = []
    lock = threading.Lock()

    def observe(st):
        with lock:
            shards.append(st.shards_processed)

    answers, errors = {}, []
    with s.service(max_batch=BATCH_K, max_wait_ms=50.0, max_inflight=2,
                   memoize=False) as svc:
        def client(c):
            try:
                futs = [(i, svc.submit(app, max_iters=ZOO_ITERS, **kw))
                        for i, (app, kw) in enumerate(queries) if i % 4 == c]
                for i, f in futs:
                    answers[i] = f.result(timeout=600)
            except BaseException as exc:  # noqa: BLE001 — checked below
                errors.append(exc)

        s.iteration_observers.append(observe)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        snap = svc.stats.snapshot()
    s.iteration_observers.clear()
    check(not errors and not any(t.is_alive() for t in threads),
          f"zoo service clients failed: {errors}")
    for i, (app, kw) in enumerate(queries):
        v = next(iter(kw.values()))
        ref = (walks[v] if app == "random_walk"
               else want[app, v] if app == "triangle_count"
               else solo[app, v])
        check(np.array_equal(answers[i].values, ref.values)
              and answers[i].iterations == ref.iterations,
              f"service {app} {kw} differs from its solo run")
    log(f"service: {len(queries)} lp/kcore/triangle_count/random_walk "
        f"queries from 4 threads in {wall:.3f}s: "
        f"qps={len(queries) / wall:.3f} p50_ms={snap['p50_ms']:.1f} "
        f"p99_ms={snap['p99_ms']:.1f} "
        f"batch_occupancy={snap['batch_occupancy']}; every answer equals "
        "its solo run")
    return sum(shards)


def baselines(tmp: Path, count) -> None:
    """(f) ESG and PSW on the card and on the CPU at SMALL_SCALE: bfs and cc
    values, iterations and bytes read/written equal, and no kernel
    launched; seconds and bytes per iteration beside the session's on a
    store of the same edges."""
    import numpy as np

    from repro_torch.baselines import ESGEngine, PSWEngine
    from repro_torch.core.apps import get_app
    from repro_torch.kernels.spmv import cuda
    from repro_torch.session import GraphSession

    src, dst, n = small_rmat()
    t0 = time.perf_counter()
    path = small_store(tmp, "small_store")
    log(f"baselines: RMAT scale {SMALL_SCALE} |V|={n} |E|={src.size}, "
        f"session store preprocessed in {time.perf_counter() - t0:.1f}s")
    for app in ("bfs", "cc"):
        # cache mode 0: every iteration reads its shards from disk, the
        # I/O model of the paper's Table 3
        with GraphSession(path, cache_mode=0) as s:
            r = s.run(app)
            count(s.config, 1, r)
        disk = sum(h.disk_bytes for h in r.history)
        log(f"baselines: session     {app:3s} iterations={r.iterations} "
            f"seconds={r.total_seconds:.3f} "
            f"s_per_iter={r.total_seconds / r.iterations:.4f} "
            f"read_per_iter={disk / r.iterations:.0f} written_per_iter=0")
        for cls in (ESGEngine, PSWEngine):
            out = {}
            for device in ("cuda", "cpu"):
                work = tmp / f"{cls.__name__}_{app}_{device}"
                eng = cls(str(work), src, dst, n, device=device)
                r0, w0 = eng.io.read, eng.io.written
                before = dict(cuda.launches)
                vals, it, secs = eng.run(get_app(app), max_iters=100)
                check(cuda.launches == before,
                      f"{cls.__name__} launched a kernel")
                out[device] = (vals, it, secs, eng.io.read - r0,
                               eng.io.written - w0)
                shutil.rmtree(work)
            g, c = out["cuda"], out["cpu"]
            check(np.array_equal(g[0], c[0]) and g[1] == c[1]
                  and g[3:] == c[3:],
                  f"{cls.__name__} {app} on the card differs from the CPU "
                  f"(iterations {g[1]}/{c[1]}, io {g[3:]}/{c[3:]})")
            check(np.array_equal(g[0], r.values),
                  f"{cls.__name__} {app} disagrees with the session")
            log(f"baselines: {cls.__name__} {app:3s} iterations={g[1]} "
                f"seconds={g[2]:.3f} s_per_iter={g[2] / g[1]:.4f} "
                f"read_per_iter={g[3] / g[1]:.0f} "
                f"written_per_iter={g[4] / g[1]:.0f} (cpu seconds "
                f"{c[2]:.3f}; values and bytes equal)")


# --------------------------------------------------------------------------
def _telemetry_line(label: str, r: dict, card: str) -> str:
    line = (f"telemetry: {label} events={r['events']} "
            f"wall_s={r['wall_seconds']:.3f} qps={r['qps']:.3f} "
            f"p50_ms={r['p50_ms']:.1f} p95_ms={r['p95_ms']:.1f} "
            f"p99_ms={r['p99_ms']:.1f} "
            f"mean_occupancy={r['mean_occupancy']:.2f} "
            f"batches={r['batches']}")
    if "hub_sample_ms" in r:
        line += f" hub_sample_ms={r['hub_sample_ms']:.3f}"
    if "adjustments" in r:
        line += (f" adjustments={r['adjustments']} "
                 f"converged={r['converged']} max_batch={r['max_batch']} "
                 f"max_wait_ms={r['max_wait_ms']:.2f}")
    if "knob_path" in r:
        line += " knob_path=" + ",".join(
            f"{int(b)}/{w:.2f}" for b, w in r["knob_path"])
    return f"{line} [{card}]"


def _check_replay(r: dict, what: str) -> None:
    check(r["completed"] == r["events"] and r["rejected"] == r["failed"] == 0
          and r.get("controller_error") is None,
          f"{what}: {r['completed']}/{r['events']} completed, "
          f"{r['rejected']} rejected, {r['failed']} failed, controller "
          f"error {r.get('controller_error')}")


def _hub_replay(s, trace, cfg, metrics: Path, shards: list, what: str,
                **kw) -> dict:
    """``replay_trace`` on ``s`` with a fresh MetricsHub emitting to
    ``metrics`` every 0.5 s; the hub's counters must equal the replay's
    IterationStats, its cache bytes and its completions.  Adds the mean
    ms of one ``hub.sample()`` (what each emit costs) to the result."""
    from repro_torch.obs import MetricsHub
    from repro_torch.serve.bench import replay_trace

    stats = []
    s.iteration_observers.append(stats.append)
    disk0 = s.stats.disk_bytes
    hub = MetricsHub(metrics, emit_interval=0.5)
    try:
        r = replay_trace(s, trace, cfg, hub=hub, **kw)
    finally:
        hub.close()
        s.iteration_observers.clear()  # the hub's tap and ours
    _check_replay(r, what)
    # the emitter's cost: one sample (pollers included) per emit interval
    t0 = time.perf_counter()
    for _ in range(10):
        snap = hub.sample()
    r["hub_sample_ms"] = (time.perf_counter() - t0) * 100
    if "adjustments" in r:  # the knobs' path, as the emitted gauges saw it
        path = [(b, w) for (_, b), (_, w) in zip(
            hub.timeseries("controller.max_batch"),
            hub.timeseries("controller.max_wait_ms"))]
        r["knob_path"] = [k for i, k in enumerate(path)
                          if i == 0 or k != path[i - 1]]
    counters, gauges = snap["counters"], snap["gauges"]
    disk = s.stats.disk_bytes - disk0
    check(counters["session.engine.iterations"] == len(stats) > 0
          and counters["session.engine.disk_bytes"] == disk
          == sum(st.disk_bytes for st in stats)
          and counters["session.engine.shards_processed"]
          == sum(st.shards_processed for st in stats)
          and gauges["serve.completed"] == r["completed"],
          f"{what}: hub counters {counters}, serve.completed "
          f"{gauges.get('serve.completed')}; expected {len(stats)} "
          f"iterations, {disk} disk bytes, {r['completed']} completed")
    shards.append(sum(st.shards_processed for st in stats))
    return r


def phase_telemetry(torch, store_path: str, bfs_seconds: float,
                    tmp: Path, card: str) -> dict:
    """Phase 10: GraphPulse on the card.  ``bfs_seconds`` is phase 5's fused
    K = 16 bfs run, from which the trace's rate and the controller's
    cadence are taken.  Returns the phase's launch counts."""
    import numpy as np

    from repro_torch.kernels.spmv import cuda
    from repro_torch.obs import validate_file
    from repro_torch.serve.bench import _default_trace
    from repro_torch.serve.graph_service import ServiceConfig
    from repro_torch.session import GraphSession

    cuda.reset_launches()
    shards: list = []  # per kernel replay: the shards its sweeps processed
    # half the rate one K = 16 sweep at a time retires, a tick per half
    # sweep (enough completions to trust a window's p99)
    qps = 0.5 * BATCH_K / bfs_seconds
    tick_s = bfs_seconds / 2
    ctl = dict(controller_interval_s=tick_s,
               controller_overrides=dict(min_samples=4, settle_ticks=3))
    cfg = ServiceConfig(max_batch=BATCH_K, max_wait_ms=50.0, max_inflight=2,
                        memoize=False)
    metrics = {k: tmp / f"metrics_{k}.jsonl"
               for k in ("static", "adaptive", "small", "cli")}
    with GraphSession(store_path, cache_mode=1,
                      cache_budget_bytes=CACHE_BUDGET) as s:
        s.warm()
        trace = _default_trace(s.n, qps=qps, duration_s=TRACE_SECONDS,
                               seed=0)
        trace.save(tmp / "trace.jsonl")
        log(f"telemetry: trace of {len(trace)} events over "
            f"{trace.duration:.1f}s at {qps:.3f} qps (3x burst in the "
            f"middle third), mix {trace.apps()}; controller tick "
            f"{tick_s:.3f}s")
        kept = {}
        sample = {0, len(trace) // 3, 2 * len(trace) // 3, len(trace) - 1}

        def keep(i, e, res):
            if i in sample:
                kept[i] = (e, res.values)

        static = _hub_replay(s, trace, cfg, metrics["static"], shards,
                             "static replay", on_result=keep)
        log(_telemetry_line("static", static, card))
        adaptive = _hub_replay(s, trace, cfg, metrics["adaptive"], shards,
                               "adaptive replay", adaptive=True,
                               slo_p99_ms=static["p99_ms"] / 2, **ctl)
        log(_telemetry_line(f"adaptive slo_p99_ms="
                            f"{static['p99_ms'] / 2:.1f}", adaptive, card))
        check(static["result_digest"] == adaptive["result_digest"],
              "the adaptive replay's digest differs from the static one")
        for i, (e, values) in sorted(kept.items()):
            solo = s.run(e.app, **e.params)
            shards.append(sum(h.shards_processed for h in solo.history))
            check(np.array_equal(values, solo.values),
                  f"replayed event {i} ({e.app} {e.params}) differs from "
                  "its solo run")
    log(f"telemetry: static and adaptive digests equal "
        f"({static['result_digest'][:16]}); events {sorted(kept)} equal "
        "their solo runs")
    small_replays(tmp, trace, qps, static["p99_ms"] / 2, shards, metrics,
                  card)
    for path in metrics.values():
        check(validate_file(path) > 0, f"{path.name} has no snapshot")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs",
         *map(str, metrics.values())], capture_output=True, text=True,
        env=_src_env(), timeout=120)
    check(out.returncode == 0, f"python -m repro_torch.obs: {out.stdout} "
                               f"{out.stderr[-2000:]}")
    log("telemetry: " + "; ".join(out.stdout.split("\n")).strip("; "))
    launches = dict(cuda.launches)
    fused = launches["ell_spmv_fused"] + launches["ell_spmv_fused_batch"]
    check(fused == sum(shards) > 0 and launches["ell_spmv_fused_batch"] > 0
          and launches["ell_fold"] + launches["ell_fold_batch"]
          + launches["ell_gather_fold"] == 0,
          f"telemetry: launches {launches}, expected {sum(shards)} fused")
    log(f"telemetry: launches {launches} equal the shards the kernel "
        "sessions' sweeps processed")
    return launches


def _src_env() -> dict:
    return {**os.environ, "PYTHONPATH": str(ROOT / "src")}


def small_replays(tmp: Path, big_trace, qps: float, slo_ms: float,
                  shards: list, metrics: dict, card: str) -> None:
    """(d) The same mix at SMALL_SCALE: one trace replayed on a cuda
    session with kernels, one with ``use_kernel=False`` and a
    ``device="cpu"`` session, and by the bench CLI in a subprocess on the
    card while the cpu session replays; the four digests must be
    equal."""
    from repro_torch.serve.bench import _default_trace, replay_trace
    from repro_torch.serve.graph_service import ServiceConfig
    from repro_torch.session import GraphSession

    path = tmp / "small_store"  # phase 9's
    if not (path / "property.json").exists():
        small_store(tmp, "small_store")
    n = small_rmat()[2]
    # the 3x burst over a third of the trace: 5/3 of qps on average
    trace = _default_trace(n, qps=qps, duration_s=SMALL_EVENTS / qps * 0.6,
                           seed=1)
    trace_file = trace.save(tmp / "trace_small.jsonl")
    check(trace.apps().keys() == big_trace.apps().keys(),
          f"scale-{SMALL_SCALE} trace mix {trace.apps()}")
    cfg = ServiceConfig(max_batch=BATCH_K, max_wait_ms=50.0, max_inflight=2,
                        memoize=False)
    digests = {}
    cli = None
    try:
        for label, kw in (("cuda", {}), ("cuda plain", dict(use_kernel=False)),
                          ("cpu", dict(device="cpu"))):
            if label == "cpu":  # the CLI replays on the card meanwhile
                t0 = time.perf_counter()
                cli = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.serve.bench", "--mode",
                     "replay", "--replay-trace", str(trace_file), "--graph",
                     str(path), "--adaptive", "--slo-p99-ms", f"{slo_ms:.3f}",
                     "--speed", str(SMALL_SPEED), "--metrics",
                     str(metrics["cli"])], stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True, env=_src_env())
            with GraphSession(str(path), **kw) as s:
                if label == "cuda":
                    r = _hub_replay(s, trace, cfg, metrics["small"], shards,
                                    f"scale-{SMALL_SCALE} replay",
                                    speed=SMALL_SPEED)
                else:
                    r = replay_trace(s, trace, cfg, speed=SMALL_SPEED)
                    _check_replay(r, f"scale-{SMALL_SCALE} {label} replay")
            digests[label] = r["result_digest"]
            log(_telemetry_line(f"scale {SMALL_SCALE} {label} "
                                f"speed={SMALL_SPEED}", r, card))
        stdout, stderr = cli.communicate(timeout=300)
    finally:
        if cli is not None and cli.poll() is None:
            cli.kill()
            cli.wait()
    check(cli.returncode == 0, f"bench CLI exited {cli.returncode}: "
                               f"{stdout[-2000:]} {stderr[-2000:]}")
    lines = stdout.splitlines()
    digest = [ln.split("=", 1)[1] for ln in lines
              if ln.startswith("# result_digest=")]
    digests["cli"] = digest[0] if digest else None
    log(f"telemetry: bench CLI, beside the cpu replay, done "
        f"{time.perf_counter() - t0:.1f}s after its start: "
        + " | ".join(ln for ln in lines if not ln.startswith("mode,")))
    check(len(set(digests.values())) == 1,
          f"scale-{SMALL_SCALE} replay digests differ: {digests}")
    log(f"telemetry: scale-{SMALL_SCALE} digests of the kernel, plain, cpu "
        f"and CLI replays equal ({digests['cli'][:16]})")


# --------------------------------------------------------------------------
# phase 11: LLM serving
# --------------------------------------------------------------------------
def _near_tie_or_equal(torch, model, batch: dict, got, want,
                       what: str) -> None:
    """``got`` must equal ``want`` (greedy tokens [B, T]), except from a
    step where ``model``'s own top two logits are closer than
    ``LLM_MARGIN`` (either token is right there)."""
    import numpy as np
    if np.array_equal(got, want):
        return
    full = {k: torch.as_tensor(v).to(model.device) for k, v in batch.items()}
    full["tokens"] = torch.cat(
        [full["tokens"].long(), torch.as_tensor(want[:, :-1]).long().to(
            model.device)], dim=1)
    if "positions" in full:  # the VLM stub: patches, then the tokens
        n = full["tokens"].shape[1] + model.cfg.img_patches
        full["positions"] = torch.arange(n, device=model.device)[
            None, :, None].expand(got.shape[0], n, 3)
    with torch.inference_mode():
        logits, _ = model(full)
    top2 = logits[:, -want.shape[1]:].topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    for row in range(got.shape[0]):
        differ = np.flatnonzero(got[row] != want[row])
        if differ.size:
            step = differ[0]
            check(margins[row, step] < LLM_MARGIN,
                  f"{what}: row {row} differs at step {step} (margin "
                  f"{margins[row, step]:.3g}): {got[row]} vs {want[row]}")
    log(f"llm: {what}: tokens differ only after near ties (< {LLM_MARGIN})")


def llm_full_width(torch, card: str) -> dict:
    """(a) gemma-2b at its published width in bf16: ``ServeEngine.generate``
    on LLM_BATCH prompts of LLM_PROMPT tokens, LLM_TOKENS greedy tokens."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_batch
    from repro_torch.models.model import Model, padded_vocab
    from repro_torch.serve import ServeEngine

    cfg = get_config(LLM_ARCH)
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    engine = ServeEngine(model)
    batch = make_batch(cfg, LLM_BATCH, LLM_PROMPT, seed=0)
    warm, _ = engine.generate(batch, num_tokens=2)  # cuBLAS plans, caches
    torch.cuda.reset_peak_memory_stats()
    toks, stats = engine.generate(batch, num_tokens=LLM_TOKENS)
    peak = torch.cuda.max_memory_allocated()
    check(toks.shape == (LLM_BATCH, LLM_TOKENS) and toks.min() >= 0
          and toks.max() < padded_vocab(cfg),
          f"llm: gemma-2b tokens {toks.shape} in [{toks.min()}, "
          f"{toks.max()}]")
    check(np.array_equal(toks[:, :2], warm),
          "llm: gemma-2b's first two greedy tokens differ between runs")
    params = model.param_count()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    kv = (2 * cfg.num_layers * LLM_BATCH * (LLM_PROMPT + LLM_TOKENS)
          * cfg.num_kv_heads * cfg.resolved_head_dim * 2)
    steps = LLM_TOKENS - 1
    out = {
        "params": params, "weight_bytes": weights, "init_s": init_s,
        "prefill_s": stats.prefill_seconds,
        "decode_tok_s": stats.tokens_per_second,
        "ms_per_step": stats.decode_seconds / steps * 1e3,
        "bound_ms": (weights + kv) / HBM_BYTES_PER_S * 1e3,
        "ops_bound_ms": 2 * params * LLM_BATCH / BF16_FLOPS * 1e3,
        "peak_gb": (peak - held) / 1e9,
    }
    log(f"llm: gemma-2b bf16 ({params:,} params, {weights:,} weight bytes, "
        f"built in {init_s:.2f}s): B={LLM_BATCH} prompt={LLM_PROMPT} "
        f"tokens={LLM_TOKENS}: prefill {out['prefill_s']:.4f}s, decode "
        f"{out['decode_tok_s']:.1f} tok/s = {out['ms_per_step']:.3f} ms a "
        f"step over {steps} steps (bound {out['bound_ms']:.3f} ms: weights "
        f"+ {kv:,} KV bytes at 3.35 TB/s; operations "
        f"{out['ops_bound_ms']:.4f} ms), peak memory {out['peak_gb']:.3f} "
        f"GB above the {held / 1e9:.3f} GB held before the model; {card}")
    out.update(profile_decode(torch, model, batch, out["ms_per_step"]))
    del engine, model
    torch.cuda.empty_cache()
    return out


def profile_decode(torch, model, batch: dict, ms_per_step: float) -> dict:
    """LLM_PROFILE_STEPS greedy decode steps after a prefill, under
    torch.profiler: the kernels a step launches and the device's busy time
    a step, against the step's unprofiled time."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        tokens = torch.as_tensor(batch["tokens"]).long().cuda()
        logits, caches, _ = model.prefill(
            {"tokens": tokens}, cache_len=LLM_PROMPT + LLM_PROFILE_STEPS)
        tok = logits[:, 0].argmax(-1)[:, None]
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(LLM_PROFILE_STEPS):
                    logits, caches = model.decode_step(caches, tok,
                                                       LLM_PROMPT + i)
                    tok = logits[:, 0].argmax(-1)[:, None]
                torch.cuda.synchronize()
    device = [(e.self_device_time_total, e.key, e.count)
              for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(d[0] for d in device) / 1e3 / LLM_PROFILE_STEPS
    kernels = sum(d[2] for d in device) / LLM_PROFILE_STEPS
    log(f"llm: profile of {LLM_PROFILE_STEPS} decode steps: "
        f"{kernels:.0f} device ops a step, device busy {busy_ms:.3f} ms a "
        f"step = {busy_ms / ms_per_step:.3f} of the unprofiled step")
    for us, key, count in sorted(device, reverse=True)[:6]:
        log(f"llm:   {us / 1e3 / LLM_PROFILE_STEPS:8.3f} ms a step  "
            f"x{count // LLM_PROFILE_STEPS:<5d} {key[:90]}")
    return {"device_ms_per_step": busy_ms, "ops_per_step": kernels}


def llm_float32_decode(torch) -> float:
    """(b) gemma-2b at full width in float32: prefill, then LLM_F32_STEPS
    decode steps, each step's logits against the teacher-forced forward's
    at the same position.  Returns the largest difference."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_batch
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(get_config(LLM_ARCH), dtype="float32")
    model = Model(cfg, device="cuda", seed=0)
    batch = make_batch(cfg, LLM_F32_BATCH, LLM_PROMPT + LLM_F32_STEPS, seed=0)
    tokens = torch.as_tensor(batch["tokens"]).long().cuda()
    P = LLM_PROMPT
    worst = 0.0
    with torch.inference_mode():
        ref, _ = model({"tokens": tokens})
        logits, caches, _ = model.prefill({"tokens": tokens[:, :P]},
                                          cache_len=P + LLM_F32_STEPS)
        steps = [logits[:, 0]]
        for i in range(LLM_F32_STEPS):
            logits, caches = model.decode_step(caches,
                                               tokens[:, P + i:P + i + 1],
                                               P + i)
            steps.append(logits[:, 0])
        for i, got in enumerate(steps):
            want = ref[:, P - 1 + i]
            err = (got - want).abs()
            bad = err > LLM_F32_ATOL + LLM_F32_RTOL * want.abs()
            worst = max(worst, float(err.max()))
            check(torch.isfinite(got).all().item() and not bad.any().item(),
                  f"llm: gemma-2b float32 step {i} (0: prefill): max "
                  f"|decode - forward| "
                  f"{float(err.max()):.3g} beyond atol {LLM_F32_ATOL} + rtol "
                  f"{LLM_F32_RTOL}")
    log(f"llm: gemma-2b float32 B={LLM_F32_BATCH}: prefill + "
        f"{LLM_F32_STEPS} decode steps equal the teacher-forced forward "
        f"(max |diff| {worst:.3g}, |logit| up to {float(ref.abs().max()):.3g};"
        f" atol {LLM_F32_ATOL}, rtol {LLM_F32_RTOL})")
    del model, ref
    torch.cuda.empty_cache()
    return worst


def llm_card_vs_cpu(torch) -> dict:
    """(c) Every architecture at ``reduced()`` size in float32, the same
    weights on the card and on the CPU: prefill logits, LLM_F32_STEPS
    decode steps' logits and 8 greedy tokens, to LLM_CARD_CPU_TOL."""
    import numpy as np

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.serve import make_batch
    from repro_torch.models.model import Model
    from repro_torch.serve import ServeEngine

    worst = {}
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        extra = cfg.img_patches if cfg.modality_stub == "image_patches" else 0
        cpu = Model(cfg, device="cpu", seed=0)
        card = Model(cfg, device="meta").to_empty(device="cuda")
        card.load_state_dict(cpu.state_dict())
        batch = make_batch(cfg, 2, 16 + LLM_F32_STEPS, seed=0)
        if extra:
            batch["positions"] = batch["positions"][:, :16 + extra]
        logits = {}
        for name, model in (("cpu", cpu), ("cuda", card)):
            dev = model.device
            b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            b["tokens"] = b["tokens"].long()
            pre = dict(b, tokens=b["tokens"][:, :16])
            with torch.inference_mode():
                out, caches, enc = model.prefill(
                    pre, cache_len=16 + extra + LLM_F32_STEPS)
                seq = [out[:, 0]]
                for i in range(LLM_F32_STEPS):
                    out, caches = model.decode_step(
                        caches, b["tokens"][:, 16 + i:17 + i], 16 + extra + i,
                        enc_out=enc)
                    seq.append(out[:, 0])
            logits[name] = torch.stack(seq, 1).cpu().numpy()
        err = np.abs(logits["cuda"] - logits["cpu"])
        bound = LLM_CARD_CPU_TOL * (1 + np.abs(logits["cpu"]))
        check(np.isfinite(logits["cuda"]).all() and (err <= bound).all(),
              f"llm: {arch} reduced: max |cuda - cpu| {err.max():.3g}")
        prompt = dict(batch, tokens=batch["tokens"][:, :16])
        toks = {name: ServeEngine(model, device=model.device).generate(
            prompt, num_tokens=8)[0] for name, model in (("cpu", cpu),
                                                         ("cuda", card))}
        _near_tie_or_equal(torch, cpu, prompt, toks["cuda"], toks["cpu"],
                           f"{arch} reduced greedy")
        worst[arch] = float(err.max())
    log("llm: reduced configs, cuda vs cpu, prefill + "
        f"{LLM_F32_STEPS} decode steps (max |diff|, tolerance "
        f"{LLM_CARD_CPU_TOL} abs and rel): "
        + ", ".join(f"{a} {e:.3g}" for a, e in worst.items())
        + "; 8 greedy tokens equal")
    return worst


def phase_llm(torch, card: str) -> dict:
    """Phase 11: the LLM serving path.  It must launch no SpMV kernel."""
    from repro_torch.kernels.spmv import cuda

    before = dict(cuda.launches)
    out = llm_full_width(torch, card)
    out["f32_max_diff"] = llm_float32_decode(torch)
    out["reduced_max_diff"] = llm_card_vs_cpu(torch)
    check(dict(cuda.launches) == before,
          f"llm: SpMV launches moved: {before} -> {dict(cuda.launches)}")
    log("llm: no SpMV kernel launched")
    return out


# --------------------------------------------------------------------------
# phase 12: LLM training
# --------------------------------------------------------------------------
def _on(torch, batch: dict, dev) -> dict:
    """Numpy inputs -> tensors on ``dev`` (ids as int64)."""
    return {k: torch.as_tensor(v).to(dev).long()
            if k in ("tokens", "targets", "positions")
            else torch.as_tensor(v).to(dev) for k, v in batch.items()}


def train_inputs(cfg, batch: int = 2, seq: int = 16) -> dict:
    """``seq`` random tokens (numpy seed 0), their next tokens as targets,
    and the stubs' inputs (``launch.serve.make_batch``)."""
    from repro_torch.launch.serve import make_batch

    full = make_batch(cfg, batch, seq + 1, seed=0)
    out = dict(full, tokens=full["tokens"][:, :seq],
               targets=full["tokens"][:, 1:])
    if "positions" in out:
        out["positions"] = out["positions"][:, :seq + cfg.img_patches]
    return out


def train_full_width(torch, card: str) -> dict:
    """(a) gemma-2b at its published width and depth in bf16, trained
    with AdamW (float32 masters) and remat for TRAIN_STEPS steps."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.train import OptConfig, make_init_state, make_train_step
    from repro_torch.train.data import SyntheticLM

    cfg = get_config(TRAIN_ARCH)
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="cuda", seed=0)
    opt = OptConfig(**TRAIN_OPT)
    state = make_init_state(model, opt)()
    step = make_train_step(model, opt)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [_on(torch, data.get_batch(i), "cuda")
               for i in range(TRAIN_CYCLE)]
    losses, seconds = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i % TRAIN_CYCLE])
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"train: gemma-2b losses {losses}")
    params = model.param_count()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = float(np.median(seconds[TRAIN_TIMED_FROM:]))
    flop_bound_ms = 8 * params * tokens / BF16_FLOPS * 1e3
    # m, v and master read and written (float32), grads read, params
    # written (bf16)
    opt_bytes = params * (3 * 2 * 4 + 2 + 2)
    out = {"params": params, "losses": losses, "step_s": step_s,
           "tok_s": tokens / step_s, "flop_bound_ms": flop_bound_ms,
           "flop_share": flop_bound_ms / (step_s * 1e3),
           "opt_bound_ms": opt_bytes / HBM_BYTES_PER_S * 1e3,
           "peak_gb": (peak - held) / 1e9}
    log(f"train: gemma-2b bf16 ({params:,} params), AdamW + fp32 masters, "
        f"remat: B={TRAIN_BATCH} S={TRAIN_SEQ}, {TRAIN_STEPS} steps over "
        f"{TRAIN_CYCLE} batches: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"step {step_s * 1e3:.1f} ms (median of steps "
        f"{TRAIN_TIMED_FROM + 1}-{TRAIN_STEPS}; first "
        f"{seconds[0] * 1e3:.1f} ms) = {out['tok_s']:.0f} tok/s; FLOP bound "
        f"{flop_bound_ms:.2f} ms (8 N T at 989 TFLOP/s) = "
        f"{out['flop_share']:.3f} of the step; peak memory "
        f"{out['peak_gb']:.3f} GB above the {held / 1e9:.3f} GB held before "
        f"the model; {card}")
    out.update(optimizer_time(torch, model, state, batches[0], opt, out))
    out.update(profile_train_step(torch, step, state, batches[0], step_s))
    out.update(real_step_counts(torch, step, state, batches[0]))
    del model, state, step, batches
    torch.cuda.empty_cache()
    return out


def optimizer_time(torch, model, state, batch, opt, out: dict) -> dict:
    """One more step by its parts: the loss and backward, then
    ``apply_updates`` alone between CUDA events, against its byte bound."""
    from repro_torch.train.optimizer import apply_updates
    from repro_torch.train.train_step import stacked_grads

    with torch.enable_grad():
        loss, _ = model.loss_fn(batch)
        loss.backward()
    grads = stacked_grads(state.params)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    apply_updates(state.params, grads, state.opt, opt)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    share = out["opt_bound_ms"] / ms
    log(f"train: apply_updates (AdamW, {len(state.params)} stacked leaves) "
        f"{ms:.2f} ms against its byte bound {out['opt_bound_ms']:.2f} ms "
        f"(m, v, master read and written, bf16 grads read and params "
        f"written at 3.35 TB/s) = {share:.3f}")
    del grads
    return {"opt_ms": ms, "opt_share": share}


def profile_train_step(torch, step, state, batch, step_s: float) -> dict:
    """One training step under torch.profiler: device ops, device busy
    time, and its share of the unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(state, batch)
            torch.cuda.synchronize()
    device = [(e.self_device_time_total, e.key, e.count)
              for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    busy_ms = sum(d[0] for d in device) / 1e3
    ops = sum(d[2] for d in device)
    # cuBLAS's matmul kernels (nvjet_*, *gemm*), the rest is elementwise,
    # reductions and copies
    mm_ms = sum(d[0] for d in device
                if "nvjet" in d[1] or "gemm" in d[1].lower()) / 1e3
    log(f"train: profile of one step: {ops} device ops, device busy "
        f"{busy_ms:.1f} ms = {busy_ms / (step_s * 1e3):.3f} of the "
        f"unprofiled step; matmul kernels {mm_ms:.1f} ms")
    for us, key, count in sorted(device, reverse=True)[:8]:
        log(f"train:   {us / 1e3:8.2f} ms  x{count:<5d} {key[:90]}")
    return {"device_ms": busy_ms, "device_ops": ops, "matmul_ms": mm_ms}


def real_step_counts(torch, step, state, batch) -> dict:
    """One more step under ``FlopCounterMode``, and the bytes of the real
    state and batch, for phase 14's dry run to match.  The batch goes in
    as int32, the dtype of ``SyntheticLM``'s, the reference's and the dry
    run's batch."""
    from torch.utils.flop_counter import FlopCounterMode

    batch = {k: v.to(torch.int32) for k, v in batch.items()}
    with FlopCounterMode(display=False) as fc:
        step(state, batch)
    torch.cuda.synchronize()
    tensors = ([t for leaf in state.params for t in leaf.tensors]
               + [state.opt["step"], state.step]
               + [t for st in state.opt["ema"].values() for t in st.values()])
    return {"step_flops": fc.get_total_flops(),
            "state_bytes": sum(t.numel() * t.element_size()
                               for t in tensors),
            "batch_bytes": sum(t.numel() * t.element_size()
                               for t in batch.values())}


def train_card_vs_cpu(torch) -> dict:
    """(b) One training step of each reduced architecture in float32, the
    same weights on the card and on the CPU; then stablelm-1.6b with
    Adafactor, with int8 error feedback and with remat policy "dots".
    The loss, every gradient and the gradient norm come from each
    device's own forward and backward.  The optimizer step then takes the
    CPU's gradients on both devices: the first AdamW or Adafactor step
    divides each gradient by its own magnitude, so a gradient within
    float32 noise of 0 may move its parameter anywhere in +-lr, on either
    device (stablelm's w_gate: 1.98e-4 apart at lr 6e-4)."""
    import numpy as np

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models.model import Model
    from repro_torch.train import OptConfig, make_init_state
    from repro_torch.train.optimizer import apply_updates, clip_by_global_norm
    from repro_torch.train.train_step import ef_compress_grads, stacked_grads

    cases = [(a, a, {}, {}) for a in ARCH_IDS] + [
        ("stablelm-1.6b adafactor", "stablelm-1.6b", {"name": "adafactor"},
         {}),
        ("stablelm-1.6b int8 ef", "stablelm-1.6b", {},
         {"grad_compression": True}),
        ("stablelm-1.6b dots", "stablelm-1.6b", {}, {"remat_policy": "dots"})]

    def close(a, b, scale, what: str) -> float:
        diff = np.abs(a - b)
        check(bool((diff <= TRAIN_CARD_CPU_TOL * (scale + np.abs(b))).all()),
              f"train: {what}: max |cuda - cpu| {diff.max():.3g}")
        return float(diff.max())

    worst = {}
    for label, arch, opt_kw, kw in cases:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        model_kw = {k: v for k, v in kw.items() if k == "remat_policy"}
        gc = kw.get("grad_compression", False)
        opt = OptConfig(**TRAIN_OPT, **opt_kw)
        cpu = Model(cfg, device="cpu", seed=0, **model_kw)
        card = Model(cfg, device="meta", **model_kw).to_empty(device="cuda")
        card.load_state_dict(cpu.state_dict())
        batch = train_inputs(cfg)
        runs = {}
        for name, model in (("cpu", cpu), ("cuda", card)):
            state = make_init_state(model, opt, grad_compression=gc)()
            with torch.enable_grad():
                loss, _ = model.loss_fn(_on(torch, batch, model.device))
                loss.backward()
            grads = stacked_grads(state.params)
            gnorm = clip_by_global_norm(grads, opt.clip_norm)[1]
            runs[name] = (model, state, float(loss.detach()), grads,
                          float(gnorm))
        cpu_run, card_run = runs["cpu"], runs["cuda"]
        err = close(card_run[2], cpu_run[2], 1.0, f"{label}: loss")
        err = max(err, close(card_run[4], cpu_run[4], 1.0,
                             f"{label}: grad norm"))
        for leaf, a, b in zip(cpu_run[1].params, card_run[3], cpu_run[3]):
            b = b.numpy()
            err = max(err, close(a.cpu().numpy(), b, np.abs(b).max(),
                                 f"{label}: {leaf.path} gradient"))
        for model, state, _, _, _ in runs.values():
            grads = [g.to(model.device) for g in cpu_run[3]]
            if gc:
                grads, _ = ef_compress_grads(
                    grads, [state.ef[leaf.path] for leaf in state.params])
            apply_updates(state.params, grads, state.opt, opt)
        after = card.state_dict()
        for key, want in cpu.state_dict().items():
            err = max(err, close(after[key].cpu().numpy(), want.numpy(), 1.0,
                                 f"{label}: {key} after the step"))
        worst[label] = err
    log("train: reduced configs in float32 on the card and on the CPU: "
        "loss, gradients, grad norm, and the parameters after an optimizer "
        f"step on the same gradients (max |diff|; tolerance "
        f"{TRAIN_CARD_CPU_TOL} abs and rel, gradients relative to their "
        "leaf's largest): "
        + ", ".join(f"{a} {e:.3g}" for a, e in worst.items()))
    return worst


def train_resume(torch, tmp: Path) -> float:
    """(c) stablelm-1.6b reduced in bf16 on the card: ten steps in one go
    against five, a save, a restore into a fresh state (another seed) and
    five more.  Returns the largest relative gap of the last five losses."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.train import OptConfig, make_init_state, make_train_step
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.data import SyntheticLM

    cfg = get_config("stablelm-1.6b").reduced()
    opt = OptConfig(**TRAIN_OPT)
    data = SyntheticLM(cfg.vocab_size, 32, 8)
    batches = [_on(torch, data.get_batch(i), "cuda") for i in range(4)]

    def run(model, state, start: int, n: int) -> list:
        step = make_train_step(model, opt)  # updates ``state`` in place
        losses = []
        for i in range(start, start + n):
            _, metrics = step(state, batches[i % 4])
            losses.append(float(metrics["loss"]))
        return losses

    model = Model(cfg, device="cuda", seed=0)
    straight = run(model, make_init_state(model, opt)(), 0, 10)
    model = Model(cfg, device="cuda", seed=0)
    state = make_init_state(model, opt)()
    first = run(model, state, 0, 5)
    ck = CheckpointManager(tmp / "resume")
    ck.save(5, state, sync=True)
    ck.close()
    fresh = Model(cfg, device="cuda", seed=1)
    restored, at = CheckpointManager(tmp / "resume").restore(
        make_init_state(fresh, opt)())
    check(at == 5 and int(restored.step) == 5, f"train: restored step {at}")
    resumed = first + run(fresh, restored, 5, 5)
    gap = float(np.max(np.abs(np.array(resumed) - straight)
                       / np.abs(straight)))
    check(gap <= TRAIN_RESUME_RTOL,
          f"train: resumed losses {resumed} vs {straight} (max rel gap "
          f"{gap:.3g} > {TRAIN_RESUME_RTOL})")
    log(f"train: stablelm-1.6b reduced bf16 on the card: 5 steps + save + "
        f"restore into a fresh model + 5 steps equal 10 straight steps "
        f"(max rel gap {gap:.3g}, tolerance {TRAIN_RESUME_RTOL})")
    return gap


def train_kill_resume(tmp: Path) -> float:
    """(d) ``python -m repro_torch.launch.train`` on the card, SIGTERM once
    step TRAIN_KILL_AFTER is printed (after the first checkpoint), then
    ``--resume`` to the 40th step.  Returns the final loss."""
    import signal

    ck = tmp / "kill"
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "stablelm-1.6b", "--reduced", "--steps", "40", "--batch", "4",
           "--seq", "32", "--ckpt-dir", str(ck), "--ckpt-every", "5",
           "--lr", "3e-3"]
    proc = subprocess.Popen(cmd + ["--log-every", "1"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_src_env())
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith(f"step {TRAIN_KILL_AFTER} "):
                proc.send_signal(signal.SIGTERM)
                break
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    out = "".join(lines) + out
    check(proc.returncode == 0 and "signal received: emergency checkpoint "
          "at" in out, f"train: killed run rc {proc.returncode}: "
          f"{out[-1000:]} {err[-2000:]}")
    killed_at = int(out.split("emergency checkpoint at")[1].split()[0])
    r = subprocess.run(cmd + ["--resume", "--log-every", "10"],
                       capture_output=True, text=True, timeout=300,
                       env=_src_env())
    check(r.returncode == 0 and f"resumed from step {killed_at}" in r.stdout
          and "done: 40 steps" in r.stdout,
          f"train: resumed run rc {r.returncode}: {r.stdout[-1000:]} "
          f"{r.stderr[-2000:]}")
    final = float(r.stdout.strip().splitlines()[-1].split()[-1])
    check(final < 7.0, f"train: final loss {final} after kill and resume")
    log(f"train: launch.train on the card killed at step {killed_at} "
        f"(SIGTERM after step {TRAIN_KILL_AFTER}), resumed to 40: final loss "
        f"{final:.4f}")
    return final


def phase_train(torch, card: str, tmp: Path) -> dict:
    """Phase 12: the LLM training path.  It must launch no SpMV kernel."""
    from repro_torch.kernels.spmv import cuda

    before = dict(cuda.launches)
    out = train_full_width(torch, card)
    out["card_cpu_max_diff"] = train_card_vs_cpu(torch)
    out["resume_gap"] = train_resume(torch, tmp)
    out["kill_resume_loss"] = train_kill_resume(tmp)
    check(dict(cuda.launches) == before,
          f"train: SpMV launches moved: {before} -> {dict(cuda.launches)}")
    log("train: no SpMV kernel launched")
    return out


# --------------------------------------------------------------------------
# phase 13: the mesh
# --------------------------------------------------------------------------
def lane_mesh(dev, shape: tuple, axes=("data", "model")):
    """A mesh whose lanes all sit on ``dev``."""
    import math

    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape, axes, devices=[dev] * math.prod(shape))


def sharing(torch, model, cfg, ctx, **kw):
    """A ``Model`` on ``ctx`` that holds ``model``'s own pieces (no copy):
    ``ctx`` must lay every weight out as ``model``'s does."""
    from repro_torch.models.model import Model
    from repro_torch.models.nn import named_weights

    other = Model(cfg, ctx=ctx, device="meta", **kw)
    mine = dict(named_weights(model))
    for name, w in list(named_weights(other)):
        src = mine[name]
        check(tuple(src.spec) == tuple(w.spec),
              f"mesh: {name} laid out {src.spec} here, {w.spec} there")
        parent, _, attr = name.rpartition(".")
        setattr(other.get_submodule(parent), attr, src)
    return other


def no_views(torch, model, what: str) -> int:
    """Check that every piece of ``model``'s expert weights has storage of
    its own, of its size (no lane's piece a view of another lane's
    tensor); -> the pieces checked."""
    from repro_torch.models.nn import named_weights

    n = 0
    for name, w in named_weights(model):
        if ".moe.w_" not in name:
            continue
        ptrs = [p.untyped_storage().data_ptr() for p in w.pieces]
        check(len(set(ptrs)) == len(ptrs) and all(
            p.untyped_storage().nbytes() == p.numel() * p.element_size()
            for p in w.pieces),
            f"mesh: {what}: {name}'s pieces share storage")
        n += len(ptrs)
    check(n > 0, f"mesh: {what}: no expert piece found")
    return n


def _close(torch, got, want, tol: dict, what: str) -> float:
    err = (got.float() - want.float()).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.float().abs()
    check(bool(torch.isfinite(got).all()) and not bool(bad.any()),
          f"mesh: {what}: max |diff| {float(err.max()):.3g} beyond atol "
          f"{tol['atol']} + rtol {tol['rtol']:.3g}")
    return float(err.max())


def profile_forward(torch, run) -> tuple[float, float]:
    """(device ops, device busy ms) of one ``run()`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    device = [(e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")
              and e.self_device_time_total > 0]
    return sum(d[1] for d in device), sum(d[0] for d in device) / 1e3


def mesh_config():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(MESH_ARCH), num_layers=MESH_LAYERS)


def _time_forward(torch, model, tokens, what: str) -> tuple:
    """(logits, aux, median ms, profile) of ``model``'s forward, after
    one warm forward (cuBLAS plans)."""
    import numpy as np

    with torch.inference_mode():
        model({"tokens": tokens})
        torch.cuda.synchronize()
        times = []
        for _ in range(MESH_TIMED):
            t0 = time.perf_counter()
            logits, aux = model({"tokens": tokens})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux)),
              f"mesh: kimi {what}: logits or aux not finite")
        prof = profile_forward(torch, lambda: model({"tokens": tokens}))
    return logits, float(aux), float(np.median(times)) * 1e3, prof


def mesh_full_width(torch, card: str, dev) -> tuple:
    """(a) kimi-k2 at full width, two layers: the forward with no mesh and
    in the three EP modes on (data 2 x model 2) lanes of one card, one
    model on the card at a time (the pieces of 'a2a' and 'replicated'
    shared).  The no-mesh model also runs (b)'s baseline decode.
    Returns (numbers, (b)'s baseline)."""
    import numpy as np

    from repro_torch.dist.context import make_rules
    from repro_torch.models.model import Model

    cfg = mesh_config()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MESH_BATCH, MESH_SEQ))).long().to(dev)
    out, ms, prof, build, diffs = {}, {}, {}, {}, {}
    t0 = time.perf_counter()
    base = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = base.param_count()
    logits, aux, ms["no mesh"], prof["no mesh"] = _time_forward(
        torch, base, tokens, "no mesh")
    out["no mesh"] = (None, aux)
    del logits
    baseline = long_decode_run(torch, base, None, dev)
    del base
    torch.cuda.empty_cache()
    mesh = lane_mesh(dev, (2, 2))
    pieces = 0
    for layout, modes in (({}, (("a2a", {}),
                                ("replicated", {"ep_mode": "replicated"}))),
                          ({"serve_fsdp": False}, (("serve 2-D", {}),))):
        t0 = time.perf_counter()
        first = Model(cfg, ctx=make_rules(mesh, cfg, **layout), seed=0)
        torch.cuda.synchronize()
        build[modes[0][0]] = time.perf_counter() - t0
        pieces += no_views(torch, first, modes[0][0])
        for mode, kw in modes:
            model = first if not kw else sharing(
                torch, first, cfg, make_rules(mesh, cfg, **layout, **kw))
            logits, aux, ms[mode], prof[mode] = _time_forward(
                torch, model, tokens, mode)
            out[mode] = (None, aux)
            if mode == "a2a":  # the others are held to it, then dropped
                want = logits
            else:
                diffs[mode] = _close(torch, logits, want, MESH_BF16_TOL,
                                     f"kimi {mode} against a2a")
            del model, logits
        del first
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    log(f"mesh: {MESH_ARCH} bf16 at full width, {MESH_LAYERS} layers "
        f"({params:,} params, {params * 2 / 1e9:.1f} GB, built in "
        f"{init_s:.2f}s with no mesh; resident lane by lane on {mesh} in "
        f"{build['a2a']:.2f}s (a2a, replicated) and "
        f"{build['serve 2-D']:.2f}s (serve 2-D); {pieces} expert pieces, "
        f"each its own storage), B={MESH_BATCH} S={MESH_SEQ}: peak memory "
        f"{(peak - held) / 1e9:.3f} GB above the {held / 1e9:.3f} GB held "
        f"before; {card}")
    for mode in ms:
        log(f"mesh:   {mode:<10s} {ms[mode]:9.3f} ms a forward (median of "
            f"{MESH_TIMED}); aux {out[mode][1]:.6f}; profiled: "
            f"{prof[mode][0]} device ops, device busy {prof[mode][1]:.3f} "
            f"ms" + (f"; max |logit - a2a| {diffs[mode]:.3g}"
                     if mode in diffs else ""))
    result = {"params": params, "init_s": init_s, "build_s": build,
              "ms": ms, "peak_gb": (peak - held) / 1e9, "profile": prof,
              "max_diff": diffs, "expert_pieces": pieces}
    del want
    return result, baseline


def long_decode_run(torch, model, fed, dev) -> tuple:
    """A ``LONG_PROMPT`` prefill and ``LONG_STEPS`` greedy steps (``fed``:
    the tokens to feed instead of the greedy ones); -> (logits, greedy
    tokens, ms a step)."""
    import numpy as np

    cfg = model.cfg
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LONG_BATCH, LONG_PROMPT))).long().to(dev)
    with torch.inference_mode():
        logits, caches, _ = model.prefill({"tokens": prompt},
                                          cache_len=LONG_CACHE)
        seq, toks = [logits[:, 0]], [logits[:, 0].argmax(-1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(LONG_STEPS):
            tok = (toks[-1] if fed is None else fed[:, i])[:, None]
            logits, caches = model.decode_step(caches, tok, LONG_PROMPT + i)
            seq.append(logits[:, 0])
            toks.append(logits[:, 0].argmax(-1))
        torch.cuda.synchronize()
    return (torch.stack(seq, 1), torch.stack(toks, 1),
            (time.perf_counter() - t0) / LONG_STEPS * 1e3)


def mesh_long_decode(torch, card: str, baseline, dev) -> dict:
    """(b) ``long_context`` on (data 4 x model 1): the cache's sequence
    split over four lanes of one card, against no mesh (``baseline``,
    run by (a) on the same weights)."""
    from repro_torch.dist.context import make_rules
    from repro_torch.models.model import Model

    cfg = mesh_config()
    ctx = make_rules(lane_mesh(dev, (4, 1)), cfg, long_context=True)
    sharded = Model(cfg, ctx=ctx, seed=0, long_context=True)
    want, want_tok, base_ms = baseline
    got, got_tok, ms = long_decode_run(torch, sharded, want_tok[:, :-1], dev)
    del sharded
    torch.cuda.empty_cache()
    err = _close(torch, got, want, MESH_BF16_TOL,
                 "long-context decode against no mesh")
    top2 = want.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    differ = (got_tok != want_tok).cpu().numpy()
    tol = MESH_BF16_TOL["atol"] + MESH_BF16_TOL["rtol"] * float(
        top2[..., 0].abs().max())
    check(bool((margin[differ] < 2 * tol).all()),
          f"mesh: long-context greedy tokens differ beyond a near tie: "
          f"margins {margin[differ]}")
    log(f"mesh: long context, {MESH_ARCH} {MESH_LAYERS} layers, batch "
        f"{LONG_BATCH}, a {LONG_PROMPT}-token prefill into {LONG_CACHE} "
        f"slots, {LONG_STEPS} greedy steps: sharded over data = 4 lanes "
        f"{ms:.3f} ms a step, no mesh {base_ms:.3f} ms a step; max "
        f"|logit diff| {err:.3g}, {int(differ.sum())} of {differ.size} "
        f"greedy tokens differ (each at a near tie); {card}")
    return {"ms": ms, "no_mesh_ms": base_ms, "max_diff": err,
            "token_diffs": int(differ.sum())}


def mesh_card_vs_cpu(torch, dev) -> dict:
    """(c) Every reduced architecture in float32 on 2 x 2 lanes on the
    card and on the CPU, the same weights: logits and gradients."""
    import numpy as np

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.dist.context import make_rules
    from repro_torch.models.convert import reference_leaves
    from repro_torch.models.model import Model

    moe = ("jamba-v0.1-52b", "mixtral-8x22b", "kimi-k2-1t-a32b")
    cases = [(a, a, None, {}) for a in ARCH_IDS] + [
        (f"{a} {m}", a, None, kw) for a in moe
        for m, kw in (("replicated", {"ep_mode": "replicated"}),
                      ("serve 2-D", {"serve_fsdp": False}))] + [
        ("kimi-k2-1t-a32b cf 1.0", "kimi-k2-1t-a32b", 1.0, {})]
    lanes = {"cpu": lane_mesh(torch.device("cpu"), (2, 2)),
             "card": lane_mesh(dev, (2, 2))}

    def close(a, b, scale, what):
        diff = np.abs(a - b)
        check(bool((diff <= MESH_CARD_CPU_TOL * (scale + np.abs(b))).all()),
              f"mesh: {what}: max |card - cpu| {diff.max():.3g}")
        return float(diff.max())

    worst = {}
    for label, arch, cf, kw in cases:
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        if cf is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cf))
        ctxs = {k: make_rules(m, cfg, **kw) for k, m in lanes.items()}
        cpu = Model(cfg, ctx=ctxs["cpu"], seed=0)
        card = Model(cfg, ctx=ctxs["card"], device="meta").to_empty(
            device=dev)
        card.load_state_dict(cpu.state_dict())
        batch = train_inputs(cfg, batch=4)
        runs = {}
        for name, model in (("cpu", cpu), ("card", card)):
            b = _on(torch, batch, model.device)
            with torch.no_grad():
                logits, _ = model(b)
            loss, _ = model.loss_fn(b)
            loss.backward()
            grads = [leaf.stack([t.grad for t in leaf.tensors]).cpu().numpy()
                     for leaf in reference_leaves(model)]
            runs[name] = (logits.cpu().numpy(), float(loss.detach()), grads)
        err = close(runs["card"][0], runs["cpu"][0], 1.0, f"{label} logits")
        err = max(err, close(runs["card"][1], runs["cpu"][1], 1.0,
                             f"{label} loss"))
        for g_card, g_cpu in zip(runs["card"][2], runs["cpu"][2]):
            err = max(err, close(g_card, g_cpu, np.abs(g_cpu).max(),
                                 f"{label} gradient"))
        if arch == "gemma-2b":  # its one KV head, repeated for model = 2
            seqs = {}
            for name, model in (("cpu", cpu), ("card", card)):
                toks = torch.as_tensor(batch["tokens"]).long().to(
                    model.device)
                with torch.no_grad():
                    out, caches, _ = model.prefill(
                        {"tokens": toks[:, :12]}, cache_len=16)
                    seq = [out]
                    for i in range(2):
                        out, caches = model.decode_step(
                            caches, toks[:, 12 + i:13 + i], 12 + i)
                        seq.append(out)
                check(caches[0]["attn"]["k"].shape[2] == 2,
                      f"mesh: gemma-2b cache heads "
                      f"{caches[0]['attn']['k'].shape}")
                seqs[name] = torch.cat(seq, 1).cpu().numpy()
            err = max(err, close(seqs["card"], seqs["cpu"], 1.0,
                                 "gemma-2b prefill and decode"))
        worst[label] = err
    log("mesh: reduced configs in float32 on 2 x 2 lanes, card against "
        f"CPU: logits, loss and gradients (max |diff|; tolerance "
        f"{MESH_CARD_CPU_TOL} abs and rel, gradients relative to their "
        "leaf's largest): " + ", ".join(f"{a} {e:.3g}"
                                        for a, e in worst.items()))
    return worst


def mesh_cli(dev) -> list:
    """(d) ``launch.train --mesh 2x2`` with its four lanes on the card."""
    import numpy as np

    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mixtral-8x22b", "--reduced", "--mesh", "2x2", "--device",
         ",".join([str(dev)] * 4), "--steps", str(MESH_CLI_STEPS),
         "--batch", "4", "--seq", "32", "--lr", "3e-3", "--log-every", "1"],
        capture_output=True, text=True, timeout=300, env=_src_env())
    losses = [float(line.split()[3]) for line in r.stdout.splitlines()
              if line.startswith("step ")]
    check(r.returncode == 0 and len(losses) == MESH_CLI_STEPS
          and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"mesh: launch.train --mesh 2x2 rc {r.returncode}: "
          f"{r.stdout[-1000:]} {r.stderr[-2000:]}")
    log(f"mesh: launch.train --arch mixtral-8x22b --reduced --mesh 2x2 on "
        f"[{dev}] * 4: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{MESH_CLI_STEPS} steps")
    return losses


def lane_storage_bytes(model, state) -> tuple[list, list]:
    """Each lane's bytes of its own parameter pieces and of its optimizer
    state's parts (the sum of their storages)."""
    from repro_torch.models.nn import named_weights

    weights = [w for _, w in named_weights(model)]
    n = len(weights[0].pieces)
    params = [sum(w.pieces[i].untyped_storage().nbytes() for w in weights)
              for i in range(n)]
    ema = [sum(t.parts.flat[i].untyped_storage().nbytes()
               for st in state.opt["ema"].values() for t in st.values())
           for i in range(n)]
    return params, ema


def mesh_train(torch, card: str, dev, train: dict) -> dict:
    """(e) phase 12's cell on (data 2 x model 2) lanes of the card: the
    resident model's first ``MESH_TRAIN_STEPS`` steps against phase 12's
    losses, and each lane's bytes for phase 14."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.dist.context import make_rules
    from repro_torch.models.model import Model
    from repro_torch.train import OptConfig, make_init_state, make_train_step
    from repro_torch.train.data import SyntheticLM

    cfg = get_config(TRAIN_ARCH)
    mesh = lane_mesh(dev, (2, 2))
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, ctx=make_rules(mesh, cfg), seed=0)
    opt = OptConfig(**TRAIN_OPT)
    state = make_init_state(model, opt)()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    step = make_train_step(model, opt)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [_on(torch, data.get_batch(i), dev) for i in range(TRAIN_CYCLE)]
    losses, seconds = [], []
    for i in range(MESH_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[i % TRAIN_CYCLE])
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    want = train["losses"][:MESH_TRAIN_STEPS]
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    check(bool(np.isfinite(losses).all()) and max(gaps) <= MESH_TRAIN_RTOL,
          f"mesh: gemma-2b on 2 x 2 losses {losses} against phase 12's "
          f"{want} (max rel gap {max(gaps):.3g} > {MESH_TRAIN_RTOL})")
    params, ema = lane_storage_bytes(model, state)
    check(len(set(params)) == 1 and len(set(ema)) == 1,
          f"mesh: lanes hold different bytes: {params} {ema}")
    whole = model.param_count() * 2
    log(f"mesh: {TRAIN_ARCH} bf16 at full width on {mesh}, AdamW + fp32 "
        f"masters, remat, B={TRAIN_BATCH} S={TRAIN_SEQ}: losses "
        + ", ".join(f"{x:.4f}" for x in losses) + " against phase 12's "
        + ", ".join(f"{x:.4f}" for x in want) + f" (max rel gap "
        f"{max(gaps):.2e}, tolerance {MESH_TRAIN_RTOL}); steps "
        + ", ".join(f"{s * 1e3:.1f}" for s in seconds) + f" ms (phase 12, "
        f"no mesh: {train['step_s'] * 1e3:.1f} ms); built in {build_s:.2f}s;"
        f" a lane's own parameter bytes {params[0]:,} "
        f"({params[0] / whole:.4f} of the whole {whole:,}), optimizer "
        f"state {ema[0]:,}; peak memory {(peak - held) / 1e9:.3f} GB above "
        f"the {held / 1e9:.3f} GB held before; {card}")
    del model, state, step, batches
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": [s * 1e3 for s in seconds],
            "param_lane_bytes": params[0], "ema_lane_bytes": ema[0],
            "whole_param_bytes": whole, "max_gap": max(gaps),
            "peak_gb": (peak - held) / 1e9}


def recurrent_run(torch, model, prompt, fed) -> tuple:
    """A ``REC_PROMPT``-token prefill (after one untimed, for cuBLAS's
    plans) and ``REC_STEPS`` greedy steps (``fed``: the tokens to feed
    instead of the greedy ones) -> (logits [B, 1 + steps, V], greedy
    tokens, caches, ms the prefill, ms a step)."""
    cache_len = REC_PROMPT + REC_STEPS
    with torch.inference_mode():
        model.prefill({"tokens": prompt}, cache_len=cache_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches, _ = model.prefill({"tokens": prompt},
                                          cache_len=cache_len)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        seq, toks = [logits[:, 0]], [logits[:, 0].argmax(-1)]
        t0 = time.perf_counter()
        for i in range(REC_STEPS):
            tok = (toks[-1] if fed is None else fed[:, i])[:, None]
            logits, caches = model.decode_step(caches, tok, REC_PROMPT + i)
            seq.append(logits[:, 0])
            toks.append(logits[:, 0].argmax(-1))
        torch.cuda.synchronize()
    return (torch.stack(seq, 1), torch.stack(toks, 1), caches, prefill_ms,
            (time.perf_counter() - t0) / REC_STEPS * 1e3)


class RecurrentProbe:
    """While active: the specs each Mamba, mLSTM and sLSTM weight of
    ``model`` is gathered to (``nn.gather_to``), and the shapes the
    recurrences run on (Mamba's scan input, mLSTM's chunked q, sLSTM's
    step input)."""

    MIXERS = (".mamba.", ".mlstm.", ".slstm.")

    def __init__(self, model):
        from repro_torch.models import nn as nnm
        from repro_torch.models import ssm, xlstm
        from repro_torch.models.nn import named_weights

        self.mine = {id(w): name for name, w in named_weights(model)
                     if any(m in name for m in self.MIXERS)}
        self.gathered: dict = {}
        self.shapes: dict = {}
        self.saved = [(nnm, "gather_to"), (ssm, "_ssm_scan_chunked"),
                      (xlstm, "_mlstm_chunked"), (xlstm, "_slstm_step")]

    def __enter__(self):
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name in self.saved]
        real_gather = self.saved[0][2]

        def gather(w, target, ctx, **kw):
            if id(w) in self.mine:
                self.gathered[self.mine[id(w)]] = (tuple(w.spec),
                                                   tuple(target))
            return real_gather(w, target, ctx, **kw)
        self.saved[0][0].gather_to = gather
        for mod, name, fn in self.saved[1:]:
            def shape_of(*a, _fn=fn, _name=name, **kw):
                self.shapes.setdefault(_name, set()).add(tuple(a[0].shape))
                return _fn(*a, **kw)
            setattr(mod, name, shape_of)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False

    def model_gathers(self) -> list:
        """The recurrent weights a 'model' split was gathered off."""
        from repro_torch.dist.context import _axes_tuple

        return [name for name, (spec, target) in self.gathered.items()
                if any("model" in _axes_tuple(e)
                       and "model" not in _axes_tuple(t)
                       for e, t in zip(spec, target + (None,) * len(spec)))]


def recurrent_pair(torch, cfg, dev, prompt, fed, probe: bool) -> dict:
    """``recurrent_run`` with no mesh, then on (data 2 x model 2) lanes
    of ``dev`` from the same seed, one model on the card at a time
    (``fed``: the tokens both are fed, default the no-mesh run's greedy
    ones); ``probe``: watch the mesh run (``RecurrentProbe``) and count
    its collectives.  -> logits, tokens, times, build seconds, peak bytes
    and what the probe saw."""
    from repro_torch.dist import spmd
    from repro_torch.dist.context import make_rules
    from repro_torch.models.model import Model

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = {"held": held}
    t0 = time.perf_counter()
    base = Model(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    out["base_build"] = time.perf_counter() - t0
    out["params"] = base.param_count()
    (out["want"], out["want_tok"], _, out["base_prefill"],
     out["base_ms"]) = recurrent_run(torch, base, prompt, fed)
    del base
    torch.cuda.empty_cache()
    if fed is None:
        fed = out["want_tok"][:, :-1]
    t0 = time.perf_counter()
    out["mesh"] = lane_mesh(dev, (2, 2))
    model = Model(cfg, ctx=make_rules(out["mesh"], cfg), seed=0)
    torch.cuda.synchronize()
    out["build"] = time.perf_counter() - t0
    with contextlib.ExitStack() as stack:
        if probe:
            out["probe"] = stack.enter_context(RecurrentProbe(model))
            out["counts"] = stack.enter_context(spmd.count_collectives())
        (out["got"], out["got_tok"], caches, out["prefill"],
         out["ms"]) = recurrent_run(torch, model, prompt, fed)
    out["ssm_parts"] = {tuple(p.shape) for c in caches
                        for m, leaves in c.items() if m == "mamba"
                        for p in leaves["ssm"].parts.flat}
    del model, caches
    torch.cuda.empty_cache()
    out["peak"] = torch.cuda.max_memory_allocated() - held
    return out


def _tokens_at_near_ties(torch, got_tok, want_tok, want, tol: dict,
                         what: str) -> int:
    """Greedy tokens equal but where the no-mesh run's top two logits lie
    within twice ``tol`` (either token is right there) -> how many
    differ."""
    top2 = want.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    differ = (got_tok != want_tok).cpu().numpy()
    bound = tol["atol"] + tol["rtol"] * float(top2[..., 0].abs().max())
    check(bool((margin[differ] < 2 * bound).all()),
          f"mesh: {what} greedy tokens differ beyond a near tie: margins "
          f"{margin[differ]}")
    return int(differ.sum())


def mesh_recurrent(torch, card: str, dev) -> dict:
    """(f) xlstm-1.3b at its published width and depth and jamba at its
    published width, 8 layers (one reference unit), in bf16 on (data 2 x
    model 2) lanes of the card and with no mesh, the same weights: a
    prefill and greedy decode steps, the no-mesh tokens fed to both; for
    jamba the same in float32 (``REC_MODELS``)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.nn import RECURRENT, TP_GATHER

    started = time.perf_counter()
    out = {}
    f32_tol = dict(atol=LLM_F32_ATOL, rtol=LLM_F32_RTOL)
    for arch, layers, f32_pair in REC_MODELS:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts
                / cfg.moe.top_k))
        prompt = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (REC_BATCH, REC_PROMPT))).long().to(dev)
        r = recurrent_pair(torch, cfg, dev, prompt, None, probe=True)
        probe, counts = r["probe"], r["counts"]
        check(not probe.model_gathers() and len(probe.gathered) ==
              len(probe.mine),
              f"mesh: {arch}: recurrent weights gathered over 'model': "
              f"{probe.model_gathers()}")
        labels = {k.split(": ", 1)[1] for k in counts.labelled}
        check(RECURRENT in labels and labels <= {RECURRENT, TP_GATHER},
              f"mesh: {arch}: labelled collectives {counts.labelled}")
        Bl = REC_BATCH // 2
        if cfg.mamba is not None:
            di, N = 2 * cfg.d_model, cfg.mamba.d_state
            check(r["ssm_parts"] == {(Bl, di // 2, N)} and
                  probe.shapes["_ssm_scan_chunked"] ==
                  {(Bl, REC_PROMPT, di // 2, N)},
                  f"mesh: {arch}: ssm state parts {r['ssm_parts']}, scan "
                  f"inputs {probe.shapes.get('_ssm_scan_chunked')}")
        else:
            H, d = cfg.num_heads, cfg.d_model
            hd = int(d * cfg.xlstm.proj_factor_mlstm) // H
            check(probe.shapes["_mlstm_chunked"] ==
                  {(Bl, REC_PROMPT, H // 2, hd)} and
                  probe.shapes["_slstm_step"] == {(Bl, 4, d // 2)},
                  f"mesh: {arch}: recurrences ran on {probe.shapes}")
        got, want = r["got"].float(), r["want"].float()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()),
              f"mesh: {arch} on 2 x 2: logits not finite")
        res = {"params": r["params"], "prefill_ms": r["prefill"],
               "no_mesh_prefill_ms": r["base_prefill"], "ms": r["ms"],
               "no_mesh_ms": r["base_ms"], "max_diff": err,
               "peak_gb": r["peak"] / 1e9}
        if f32_pair:
            f = recurrent_pair(torch, dataclasses.replace(
                cfg, dtype="float32"), dev, prompt, r["want_tok"][:, :-1],
                probe=False)
            res["f32_max_diff"] = _close(
                torch, f["got"], f["want"], f32_tol,
                f"{arch} float32 on 2 x 2 against no mesh")
            res["f32_token_diffs"] = _tokens_at_near_ties(
                torch, f["got_tok"], f["want_tok"], f["want"], f32_tol,
                f"{arch} float32")
            ref = f["want"]
            base_off = float((want - ref).abs().max())
            mesh_off = float((got - ref).abs().max())
            bound = base_off + MESH_BF16_TOL["atol"] + MESH_BF16_TOL[
                "rtol"] * float(ref.abs().max())
            check(mesh_off <= bound,
                  f"mesh: {arch} bf16 on 2 x 2 {mesh_off:.3g} from float32, "
                  f"no mesh {base_off:.3g} (bound {bound:.3g})")
            res.update(bf16_off_f32=mesh_off, no_mesh_bf16_off_f32=base_off,
                       f32_peak_gb=f["peak"] / 1e9)
            gate = (f"float32 pair: max |logit diff| {res['f32_max_diff']:.3g}"
                    f" (tolerance {LLM_F32_ATOL} + {LLM_F32_RTOL} rel), "
                    f"{res['f32_token_diffs']} greedy tokens differ (each at "
                    f"a near tie), peak {res['f32_peak_gb']:.3f} GB; bf16: "
                    f"max |logit diff| {err:.3g}, {mesh_off:.3g} from "
                    f"float32 against the no-mesh run's {base_off:.3g} "
                    f"(bound {bound:.3g})")
            del f, ref
        else:
            _close(torch, got, want, MESH_BF16_TOL,
                   f"{arch} on 2 x 2 against no mesh")
            res["token_diffs"] = _tokens_at_near_ties(
                torch, r["got_tok"], r["want_tok"], want, MESH_BF16_TOL,
                arch)
            gate = (f"max |logit diff| {err:.3g}, {res['token_diffs']} of "
                    f"{r['got_tok'].numel()} greedy tokens differ (each at "
                    f"a near tie)")
        shapes = {k: sorted(v) for k, v in probe.shapes.items()}
        log(f"mesh: {arch} bf16 at full width, {cfg.num_layers} layers "
            f"({r['params']:,} params), batch {REC_BATCH}, a {REC_PROMPT}-"
            f"token prefill and {REC_STEPS} greedy steps on {r['mesh']} "
            f"against no mesh: prefill {r['prefill']:.3f} ms (no mesh "
            f"{r['base_prefill']:.3f}), {r['ms']:.3f} ms a step (no mesh "
            f"{r['base_ms']:.3f}); {gate}; built in {r['base_build']:.2f}s "
            f"with no mesh, {r['build']:.2f}s on the lanes; peak memory "
            f"{r['peak'] / 1e9:.3f} GB above the {r['held'] / 1e9:.3f} GB "
            f"held before; {card}")
        log(f"mesh:   {arch}: no recurrent weight gathered over 'model' "
            f"({len(probe.gathered)} gathered over 'data' only); a lane's "
            f"recurrences ran on {shapes}"
            + (f", its ssm state parts {sorted(r['ssm_parts'])}"
               if r["ssm_parts"] else "")
            + f"; collective bytes a lane, prefill and decode: "
            f"{dict(counts)}, of them {counts.labelled}")
        out[arch] = res
        del r, got, want
    seconds = time.perf_counter() - started
    check(seconds <= REC_SECONDS,
          f"mesh: (f) took {seconds:.1f}s, over its {REC_SECONDS:.0f}s "
          f"budget")
    log(f"mesh: (f) the recurrent blocks at full width in {seconds:.1f}s")
    out["seconds"] = seconds
    return out


def phase_mesh(torch, card: str, dev, train: dict) -> dict:
    """Phase 13: the mesh.  It must launch no SpMV kernel."""
    from repro_torch.kernels.spmv import cuda

    before = dict(cuda.launches)
    out, baseline = mesh_full_width(torch, card, dev)
    out["long"] = mesh_long_decode(torch, card, baseline, dev)
    del baseline
    torch.cuda.empty_cache()
    out["card_cpu_max_diff"] = mesh_card_vs_cpu(torch, dev)
    out["cli_losses"] = mesh_cli(dev)
    out["train"] = mesh_train(torch, card, dev, train)
    out["recurrent"] = mesh_recurrent(torch, card, dev)
    check(dict(cuda.launches) == before,
          f"mesh: SpMV launches moved: {before} -> {dict(cuda.launches)}")
    log("mesh: no SpMV kernel launched")
    return out


# --------------------------------------------------------------------------
# phase 14: the dry run
# --------------------------------------------------------------------------
def phase_dry_run(torch, card: str, train: dict, mesh_out: dict) -> dict:
    """Phase 14: phase 12's cell traced on one meta lane against phase
    12's real step: FLOPs and argument bytes equal, argument + temp
    within ``DRYRUN_PEAK_RTOL`` of the measured peak; then on (2 x 2)
    meta lanes against phase 13 (e).  It must launch no SpMV kernel."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.spmv import cuda
    from repro_torch.launch.dryrun import analyze, trace_cell
    from repro_torch.launch.shapes import ShapeSpec

    before = dict(cuda.launches)
    cfg = get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    rec = analyze(trace_cell(cfg, ShapeSpec("phase12", "train", TRAIN_SEQ,
                                            TRAIN_BATCH), None,
                             unroll=False, opt_name="adamw"))
    seconds = time.perf_counter() - t0
    mem = rec["memory"]
    args, temp = mem["argument_size_in_bytes"], mem["temp_size_in_bytes"]
    real_args = train["state_bytes"] + train["batch_bytes"]
    peak = train["peak_gb"] * 1e9
    gap = (args + temp) / peak - 1
    check(rec["flops"] == train["step_flops"],
          f"dryrun: meta FLOPs {rec['flops']} != FlopCounterMode over the "
          f"real step {train['step_flops']}")
    check(args == real_args,
          f"dryrun: meta argument bytes {args} != the real state + batch "
          f"{real_args}")
    check(abs(gap) <= DRYRUN_PEAK_RTOL,
          f"dryrun: argument + temp {(args + temp) / 1e9:.3f} GB is "
          f"{gap:+.2%} of phase 12's peak {train['peak_gb']:.3f} GB")
    eight_nt = 8 * train["params"] * TRAIN_BATCH * TRAIN_SEQ
    log(f"dryrun: {TRAIN_ARCH} B={TRAIN_BATCH} S={TRAIN_SEQ} AdamW + fp32 "
        f"masters, remat, traced on one meta lane in {seconds:.1f}s: FLOPs "
        f"{rec['flops']:.6e} equal FlopCounterMode over phase 12's step on "
        f"the card (8 N T = {eight_nt:.6e}, ratio "
        f"{rec['flops'] / eight_nt:.4f}); argument bytes {args} equal the "
        f"real state + batch; argument + temp {(args + temp) / 1e9:.3f} GB "
        f"(temp {temp / 1e9:.3f} GB, outputs "
        f"{mem['output_size_in_bytes'] / 1e9:.3f} GB) against phase 12's "
        f"measured peak {train['peak_gb']:.3f} GB ({gap:+.2%}, tolerance "
        f"{DRYRUN_PEAK_RTOL:.0%}); {card}")
    lanes = dry_run_mesh(torch, card, mesh_out["train"])
    check(dict(cuda.launches) == before,
          f"dryrun: SpMV launches moved: {before} -> {dict(cuda.launches)}")
    log("dryrun: no SpMV kernel launched")
    return {"flops": rec["flops"], "arguments": args, "temp": temp,
            "gap": gap, "trace_seconds": seconds, "mesh": lanes}


def dry_run_mesh(torch, card: str, real: dict) -> dict:
    """Phase 12's cell on (data 2 x model 2) meta lanes against phase 13
    (e)'s lanes: a lane's parameter and optimizer-state argument bytes
    equal (e)'s own storages, temp is a number, and the counted FSDP
    collectives equal ``derived_collectives``."""
    from repro_torch.configs import get_config
    from repro_torch.dist.context import make_rules
    from repro_torch.launch.dryrun import (_meta_mesh, _state_entries,
                                           analyze, derived_collectives,
                                           lane_bytes, trace_cell)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models.convert import reference_leaves
    from repro_torch.train import OptConfig, make_init_state

    cfg = get_config(TRAIN_ARCH)
    mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
    t0 = time.perf_counter()
    traced = trace_cell(cfg, ShapeSpec("phase13e", "train", TRAIN_SEQ,
                                       TRAIN_BATCH), mesh, unroll=False,
                        opt_name="adamw")
    rec = analyze(traced)
    seconds = time.perf_counter() - t0
    ctx = make_rules(_meta_mesh(mesh), cfg)
    leaves = reference_leaves(traced.model)
    params = lane_bytes([(leaf.shape, leaf.dtype, ctx.param_sharding(leaf))
                         for leaf in leaves])
    state = make_init_state(traced.model, OptConfig(**TRAIN_OPT))()
    entries = _state_entries(state, ctx)
    ema = lane_bytes(entries[len(leaves) + 1:-1])  # m, v, master
    check(params == real["param_lane_bytes"],
          f"dryrun: 2 x 2 lane parameter bytes {params} != phase 13 (e)'s "
          f"lane's own {real['param_lane_bytes']}")
    check(ema == real["ema_lane_bytes"],
          f"dryrun: 2 x 2 lane optimizer-state bytes {ema} != phase 13 "
          f"(e)'s lane's own {real['ema_lane_bytes']}")
    temp = rec["memory"]["temp_size_in_bytes"]
    check(isinstance(temp, int) and temp > 0, f"dryrun: 2 x 2 temp {temp}")
    derived = derived_collectives(leaves, ctx, True)
    colls = rec["collectives"]
    for kind in ("all-gather", "reduce-scatter"):
        named = sum(v for k, v in traced.labelled.items()
                    if k.startswith(kind + ":"))
        check(colls.get(kind, 0) - named == derived[kind],
              f"dryrun: 2 x 2 counted {kind} {colls.get(kind, 0)} (named "
              f"{named}) != the FSDP rule's {derived[kind]}")
    log(f"dryrun: {TRAIN_ARCH} on (2 x 2) meta lanes, one lane's program "
        f"traced in {seconds:.1f}s: a lane's parameters {params:,} B and "
        f"optimizer state {ema:,} B equal phase 13 (e)'s lanes' own "
        f"storages; arguments {rec['memory']['argument_size_in_bytes']:,} "
        f"B, temp {temp:,} B a lane; collectives a lane "
        + ", ".join(f"{k} {v:,} B" for k, v in sorted(colls.items()))
        + " (all-gather and reduce-scatter equal the FSDP rule); FLOPs a "
        f"lane {rec['flops']:.6e}; {card}")
    return {"param_bytes": params, "ema_bytes": ema, "temp": temp,
            "collectives": colls, "flops": rec["flops"],
            "trace_seconds": seconds}


# --------------------------------------------------------------------------
# phase 15: the examples' twins
# --------------------------------------------------------------------------
def _twin(name: str, argv: list):
    """``repro_torch.examples.<name>.main(argv)`` in this process, its
    printed lines logged under ``examples: <name>:``."""
    import contextlib
    import importlib
    import io

    main = importlib.import_module(f"repro_torch.examples.{name}").main
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return main(argv)
    finally:
        for line in buf.getvalue().splitlines():
            log(f"examples: {name}: {line}")


def _graph_twin_checks(np, name: str, got: dict, want: dict) -> dict:
    """A graph twin's card runs against its CPU runs: exact runs (and the
    batch) bitwise with their ``IterationStats``, PageRank to PR_RTOL.
    Returns the shards the card's runs processed, single-column and
    batched."""
    shards = {"single": 0, "batch": 0}
    for key, r in got.items():
        if key == "bfs":  # the IterationStats that iter_run yielded
            hist, want_hist = r, want[key]
        else:
            hist, want_hist = r.history, want[key].history
            if key in ("pagerank", "full", "checkpointed", "resumed"):
                rel = _max_rel_err(np, r.values, want[key].values)
                check(rel <= PR_RTOL, f"examples: {name} {key}: off the "
                      f"CPU's by {rel} (rtol {PR_RTOL})")
            else:
                check(np.array_equal(r.values, want[key].values),
                      f"examples: {name} {key}: values differ from the CPU's")
        check([tuple(getattr(h, f) for f in EXACT_FIELDS) for h in hist]
              == [tuple(getattr(h, f) for f in EXACT_FIELDS)
                  for h in want_hist],
              f"examples: {name} {key}: IterationStats differ from the CPU's")
        shards["batch" if key == "batch" else "single"] += sum(
            h.shards_processed for h in hist)
    return shards


def phase_examples(torch) -> dict:
    """Phase 15: the four examples' twins in this process on the card.  The
    graph twins' runs equal their ``--device cpu`` runs (exact apps bitwise
    with their IterationStats, PageRank to PR_RTOL) and launch B1 once a
    processed shard (K = 1, and K = 8 for quickstart's batch); serve_lm and
    train_tiny_lm run their own checks and launch no SpMV kernel.  Returns
    the phase's launch counts (set to 0 before the card's runs)."""
    import numpy as np

    from repro_torch.kernels.spmv import cuda

    graph = (("quickstart", []), ("graph_analytics", ["--scale", "14"]))
    cpu = {}
    for name, argv in graph:
        t0 = time.perf_counter()
        cpu[name] = _twin(name, argv + ["--device", "cpu"])
        log(f"examples: {name} --device cpu (the plain version) in "
            f"{time.perf_counter() - t0:.1f}s")
    cuda.reset_launches()
    shards = {"single": 0, "batch": 0}
    for name, argv in graph:
        t0 = time.perf_counter()
        got = _twin(name, argv + ["--device", "cuda"])
        seconds = time.perf_counter() - t0
        for k, v in _graph_twin_checks(np, name, got, cpu[name]).items():
            shards[k] += v
        log(f"examples: {name} on the card in {seconds:.1f}s: exact runs "
            "and every IterationStats bitwise equal to --device cpu, "
            f"PageRank within {PR_RTOL}")
    launches = dict(cuda.launches)
    check(launches["ell_spmv_fused"] == shards["single"] > 0
          and launches["ell_spmv_fused_batch"] == shards["batch"] > 0
          and launches["ell_fold"] == launches["ell_fold_batch"]
          == launches["ell_gather_fold"] == 0,
          f"examples: launches {launches}, expected {shards['single']} "
          f"ell_spmv_fused and {shards['batch']} ell_spmv_fused_batch")
    t0 = time.perf_counter()
    toks = _twin("serve_lm", ["--device", "cuda"])
    check(toks.shape == (4, 48), f"examples: serve_lm tokens {toks.shape}")
    t1 = time.perf_counter()
    losses = _twin("train_tiny_lm", ["--steps", "30", "--device", "cuda"])
    check(len(losses) == 30 and bool(np.isfinite(losses).all()),
          f"examples: train_tiny_lm losses {losses}")
    log(f"examples: serve_lm (mixtral-8x22b reduced, 4 x 48 greedy tokens, "
        f"twice, equal) in {t1 - t0:.1f}s; train_tiny_lm 30 steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, in "
        f"{time.perf_counter() - t1:.1f}s")
    check(dict(cuda.launches) == launches,
          f"examples: serve_lm or train_tiny_lm moved the SpMV launches: "
          f"{launches} -> {dict(cuda.launches)}")
    log("examples: serve_lm and train_tiny_lm launched no SpMV kernel")
    return launches


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
        batch_launches, batch, bfs_seconds = phase_batched(
            torch, str(store.path), solo)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launches["ell_gather_fold"] = phase_multi(
            torch, torch.device("cuda", 0), str(store.path),
            layouts["mesh"], n, tiling, solo, batch)
        log(f"multi: all comparisons passed in "
            f"{time.perf_counter() - t0:.1f}s")
        del tiling  # phases 3 and 7's tiles: no later phase reads them
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        storage_launches = phase_storage(torch, str(store.path), solo,
                                         batch[0])
        log(f"storage: all comparisons passed in "
            f"{time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        zoo_launches = phase_zoo(torch, str(store.path), batch[0], tmp)
        log(f"zoo: all comparisons passed in "
            f"{time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        telemetry_launches = phase_telemetry(torch, str(store.path),
                                             bfs_seconds, tmp, card)
        log(f"telemetry: all checks passed in "
            f"{time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_llm(torch, card)
        log(f"llm: all checks passed in {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        train = phase_train(torch, card, tmp)
        log(f"train: all checks passed in {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mesh_out = phase_mesh(torch, card, torch.device("cuda", 0), train)
        log(f"mesh: all checks passed in {time.perf_counter() - t0:.1f}s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        phase_dry_run(torch, card, train, mesh_out)
        seconds = time.perf_counter() - t0
        check(seconds <= DRYRUN_SECONDS,
              f"dryrun: phase 14 took {seconds:.1f}s, over its "
              f"{DRYRUN_SECONDS:.0f}s budget")
        log(f"dryrun: all checks passed in {seconds:.1f}s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        examples_launches = phase_examples(torch)
        seconds = time.perf_counter() - t0
        check(seconds <= EXAMPLES_SECONDS,
              f"examples: phase 15 took {seconds:.1f}s, over its "
              f"{EXAMPLES_SECONDS:.0f}s budget")
        log(f"examples: all checks passed in {seconds:.1f}s")
    finally:
        build_thread.join()
        pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(tmp, ignore_errors=True)
    # launches: run (K = 1), run_batch (K = 16), spmv_2d (B4), the storage
    # and mutation phase's (K = 1 and the service's batches), the zoo's,
    # the telemetry replays' and the examples' twins'
    for name, rec in records.items():
        rec["launches"] = ((batch_launches if name.endswith("_batch")
                            else launches)[name] + storage_launches[name]
                           + zoo_launches[name] + telemetry_launches[name]
                           + examples_launches[name])
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
