"""Multi-device VSW: GraphMP's single-writer invariant over device lanes.

GraphMP is single-machine; its no-atomics property — every in-edge of a
vertex lives in exactly one shard — extends to several devices: partition
destination intervals over D lanes (one writer lane per interval) and keep
the source array replicated, refreshed once per iteration by copying each
owner's interval back (the reference's ``all_gather``; C|V| per iteration).
A lane is one entry of a device list (``dist.context.make_data_devices``);
a list may name one device more than once, so D lanes can share a card.

``ShardedVSWEngine`` — the production path (``EngineConfig.num_devices``,
env ``GRAPHMP_DEVICES``; ``GraphSession`` routes to it).  It subclasses
``VSWEngine`` and keeps the whole I/O story: each lane owns a contiguous,
nnz-balanced run of shards (``assign_shards``), its own partition of the
edge cache (``PartitionedShardCache``: one global budget, split exactly),
its own ``ShardPipeline`` prefetch lane and, on CUDA, its own compute
stream and staging stream.  Each iteration:

    x     = gather_transform(src)                  # replicated
    waves : lane d folds its w-th scheduled shard into its own interval
            (B1 through ops.ell_spmv[_batch], or B2/B3 with
            fused_gather=False), on its own stream
    merge : each owner's interval is copied into the new source array
            (the all_gather), the lanes' changed counts are summed (the
            psum), and the changed mask is read only when the sum is > 0

A lane folds each shard at the shard's own shape, so the reference's
``[D, R, W]`` wave stacking and its identity padding have no counterpart:
results and per-iteration stats equal the single-lane engine's and the
reference's at any lane count.

``DistributedVSW`` — the all-resident prototype: the WHOLE edge set is
partitioned onto the lanes up front (``partition_for_mesh``), so there is no
disk, cache or prefetch path.  ``spmv_2d`` splits the sources as well: a
D x S grid of (destination block x source range) tiles, each folded by the
``ell_gather_fold`` kernel (B4) against its source block.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.apps import VertexProgram, get_app
from repro_torch.core.bloom import BloomFilter
from repro_torch.core.cache import PartitionedShardCache
from repro_torch.core.engine import (EngineConfig, VSWEngine, resolve_device,
                                     stage_shard)
from repro_torch.core.pipeline import ShardPipeline
from repro_torch.core.semiring import SEMIRINGS
from repro_torch.core.shards import (SUBLANE, ELLShard, build_csr_shards,
                                     csr_to_ell)
from repro_torch.dist.context import make_data_devices
from repro_torch.kernels.spmv.ops import (check_extents, ell_gather_fold,
                                          ell_spmv)
from repro_torch.kernels.spmv.ref import segment_combine


# ---------------------------------------------------------------------------
def assign_shards(intervals: np.ndarray, shard_nnz, num_devices: int
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Contiguous, nnz-balanced shard -> device assignment.

    Returns ``(owner [P], bounds [D+1])``: device ``d`` owns the shards
    ``p`` with ``owner[p] == d``, whose destination intervals tile exactly
    ``[bounds[d], bounds[d+1])``.  Contiguity keeps every device's write
    region ONE interval — the single-writer invariant survives the mesh and
    the merge step needs only static slices; greedy nnz balancing keeps
    per-device SpMV work even.  A device may own zero shards (more devices
    than shards, or one giant shard): its bounds collapse.
    """
    intervals = np.asarray(intervals, dtype=np.int64)
    P_ = len(intervals) - 1
    D = int(num_devices)
    if D < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    weights = np.asarray(shard_nnz, dtype=np.float64)
    if len(weights) != P_:
        raise ValueError(
            f"shard_nnz has {len(weights)} entries for {P_} shards")
    if weights.sum() <= 0:
        weights = np.ones(P_, dtype=np.float64)
    total = float(weights.sum())
    owner = np.zeros(P_, dtype=np.int64)
    cum, d = 0.0, 0
    for p in range(P_):
        owner[p] = d
        cum += weights[p]
        while d < D - 1 and cum >= total * (d + 1) / D:
            d += 1
    bounds = np.empty(D + 1, dtype=np.int64)
    bounds[D] = intervals[-1]
    for dd in range(D - 1, -1, -1):
        owned = np.nonzero(owner == dd)[0]
        bounds[dd] = intervals[owned[0]] if owned.size else bounds[dd + 1]
    bounds[0] = intervals[0]
    return owner, bounds


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Lane:
    """One device lane of ``ShardedVSWEngine``."""

    device: torch.device
    stream: "torch.cuda.Stream | None"       # compute stream (CUDA only)
    copy_stream: "torch.cuda.Stream | None"  # staging stream (prefetch > 0)
    pipeline: ShardPipeline | None = None

    def context(self):
        """Make this lane's stream the current one (no-op on the CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


def _join(stream, other) -> None:
    """``stream`` waits for the work enqueued on ``other`` so far (no-op
    unless both are CUDA streams)."""
    if stream is not None and other is not None:
        stream.wait_stream(other)


class ShardedVSWEngine(VSWEngine):
    """VSWEngine whose edge sweep drives ``config.num_devices`` lanes.

    The base class owns everything host-side (convergence, checkpoints,
    selective scheduling, epoch pinning); this subclass swaps the
    per-iteration internals through its seams:

    * ``_fetch_shard`` reads through the ``PartitionedShardCache``, which
      routes each shard to its owning lane's partition;
    * ``_make_pipeline`` builds one prefetch lane per device, each staging
      straight onto its lane's device and stream;
    * ``_sweep`` splits the Bloom-scheduled shard list by owner and runs it
      in waves (lane d folds its w-th shard), then merges the lanes'
      intervals into the replicated source array;
    * ``_io_marks`` / ``_io_stats`` account disk/stall/fetch per lane and as
      sums (``IterationStats.device_*`` tuples).

    ``device`` is a device list of ``config.num_devices`` lanes or a spec
    ``make_data_devices`` expands (default ``"cuda"``: one GPU a lane).
    Values live on the first lane's device.
    """

    def __init__(self, store, program, config=None, *, device="cuda",
                 cache=None, **kw):
        cfg = config if isinstance(config, EngineConfig) else EngineConfig()
        D = cfg.num_devices
        self.devices = make_data_devices(D, device)
        self._num_devices = D
        shard_meta = store.properties["shards"]
        nnz = [int(m.get("nnz", 0)) for m in shard_meta]
        self._owner, self._bounds = assign_shards(
            np.asarray(store.intervals), nnz, D)
        if not (isinstance(cache, PartitionedShardCache)
                and cache.num_partitions == D
                and np.array_equal(cache.owner, self._owner)):
            # sessions configured with num_devices build the partitioned
            # cache up front and share it; a per-run config override (or
            # direct construction) gets a private partitioned cache instead
            cache = PartitionedShardCache(
                store, self._owner, D, mode=cfg.cache_mode,
                budget_bytes=cfg.cache_budget_bytes,
                hot_fraction=cfg.cache_hot_fraction,
                promote_after=cfg.cache_promote_after)
        super().__init__(store, program, cfg, device=self.devices[0],
                         cache=cache, **kw)

    # -- construction seams ---------------------------------------------
    def _make_pipeline(self):
        # one prefetch lane per device; lane d streams only lane d's shards,
        # each fetch landing in lane d's cache partition
        depth = self.config.prefetch_depth
        self._lanes = []
        for dev in self.devices:
            on_cuda = dev.type == "cuda"
            lane = _Lane(dev, torch.cuda.Stream(dev) if on_cuda else None,
                         torch.cuda.Stream(dev) if on_cuda and depth > 0
                         else None)
            lane.pipeline = ShardPipeline(
                self._get_shard, depth=depth,
                stage=lambda shard, lane=lane: stage_shard(
                    shard, lane.device, lane.copy_stream or lane.stream),
                nbytes=ELLShard.decoded_nbytes)
            self._lanes.append(lane)
        return None  # per-lane pipelines replace the single self._pipeline

    # -- per-iteration seams ----------------------------------------------
    def _sweep(self, program, x, src, aux, it, schedule, epoch_check):
        D, B, lanes = self._num_devices, self._bounds, self._lanes
        scheds = [[p for p in schedule if self._owner[p] == d]
                  for d in range(D)]
        home = (torch.cuda.current_stream(self.device)
                if self.device.type == "cuda" else None)
        reps, blocks = [], []
        for d, lane in enumerate(lanes):
            _join(lane.stream, home)  # x, src, aux and it are ready
            with lane.context():
                # the replicated arrays on the lane's device (the same
                # tensors where the lane sits on the first lane's device)
                rep = tuple(None if t is None
                            else t.to(lane.device, non_blocking=True)
                            for t in (x, src, aux, it))
                reps.append(rep)
                blocks.append(rep[1][int(B[d]):int(B[d + 1])].clone())
        streams = [lane.pipeline.stream(scheds[d], check=epoch_check)
                   for d, lane in enumerate(lanes)]
        try:
            for w in range(max(len(s) for s in scheds)):
                for d, lane in enumerate(lanes):
                    if w >= len(scheds[d]):
                        continue
                    _p, shard, staged = next(streams[d])
                    with lane.context():
                        start, new = self._fold_shard(program, *reps[d],
                                                      shard, staged)
                        lo = start - int(B[d])
                        blocks[d][lo:lo + new.shape[0]] = new
        finally:
            for s in streams:
                s.close()  # run pipeline cleanup (reap prefetch workers)
        masks, counts = [], []
        for d, lane in enumerate(lanes):
            with lane.context():
                old = reps[d][1][int(B[d]):int(B[d + 1])]
                mask = program.changed(blocks[d], old)
                masks.append(mask)
                counts.append(mask.sum())
            _join(home, lane.stream)
            if home is not None and lane.stream is not None:
                # made on the lane's stream, read by the merge below
                for t in (blocks[d], mask, counts[-1]):
                    t.record_stream(home)
        new_src = src.clone()
        for d in range(D):
            new_src[int(B[d]):int(B[d + 1])] = blocks[d].to(self.device)
        changed_count = int(sum(c.to(self.device) for c in counts))
        if changed_count == 0:
            # the summed count short-circuits the full mask
            changed = torch.zeros((self.n,) + src.shape[1:], dtype=torch.bool,
                                  device=self.device)
        else:
            changed = torch.cat([m.to(self.device) for m in masks])
        return new_src, changed

    def _io_marks(self):
        return ([(c.stats.disk_bytes, c.stats.hits, c.stats.misses,
                  c.stats.decode_seconds_saved) for c in self.cache.parts],
                [(lane.pipeline.stats.stall_seconds,
                  lane.pipeline.stats.fetch_seconds) for lane in self._lanes])

    def _io_stats(self, marks) -> dict:
        cache_marks, lane_marks = marks
        d_disk, d_saved, hits, total = [], [], 0, 0
        for part, (disk0, hits0, misses0, saved0) in zip(self.cache.parts,
                                                         cache_marks):
            s = part.stats
            d_disk.append(s.disk_bytes - disk0)
            d_saved.append(s.decode_seconds_saved - saved0)
            hits += s.hits - hits0
            total += (s.hits - hits0) + (s.misses - misses0)
        stats = [lane.pipeline.stats for lane in self._lanes]
        d_stall = [st.stall_seconds - s0
                   for st, (s0, _f0) in zip(stats, lane_marks)]
        d_fetch = [st.fetch_seconds - f0
                   for st, (_s0, f0) in zip(stats, lane_marks)]
        return dict(
            disk_bytes=sum(d_disk),
            cache_hit_ratio=hits / total if total else 0.0,
            # lanes are drained on the one consumer thread, so its total
            # blocked time is the SUM of per-lane stalls; fetch work happens
            # per worker and also sums
            stall_seconds=sum(d_stall),
            fetch_seconds=sum(d_fetch),
            decode_seconds_saved=sum(d_saved),
            device_disk_bytes=tuple(d_disk),
            device_stall_seconds=tuple(d_stall),
            device_fetch_seconds=tuple(d_fetch),
        )


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DeviceShardedGraph:
    """Edges repartitioned so device d owns destination interval d (1-D).

    ``num_vertices`` is the TRUE vertex count; the device intervals tile
    ``padded_num_vertices`` (the next multiple of the device count), and
    every consumer masks the padding rows out of init/post/changed.  The
    arrays are numpy, as the reference's are, so a graph partitioned by
    either package runs in either ``DistributedVSW``.
    """

    num_vertices: int          # true |V|
    padded_num_vertices: int   # |V| rounded up to a multiple of num_devices
    num_edges: int
    cols: np.ndarray           # [D, R, W] int32 (per-device ELL, common shape)
    vals: np.ndarray           # [D, R, W] float32
    row_map: np.ndarray        # [D, R] int32 (local row within the device interval)
    out_deg: np.ndarray        # [padded_num_vertices] int64 (0 on padding)
    rows_per_device: int       # interval length padded_num_vertices / D
    blooms: list               # per-device source-vertex BloomFilters (replicated)


def partition_for_mesh(
    src: np.ndarray, dst: np.ndarray, num_vertices: int, num_devices: int,
    val: np.ndarray | None = None, ell_max_width: int = 256,
) -> DeviceShardedGraph:
    n_pad = ((num_vertices + num_devices - 1) // num_devices) * num_devices
    per = n_pad // num_devices
    shards = build_csr_shards(src, dst, n_pad, threshold_edge_num=1 << 62, val=val)
    # build_csr_shards with huge threshold yields one shard; re-cut at device bounds
    csr = shards[0]
    ells: list[ELLShard] = []
    blooms: list[BloomFilter] = []
    for d in range(num_devices):
        lo, hi = d * per, (d + 1) * per
        sub = dataclasses.replace(
            csr,
            shard_id=d,
            start_vertex=lo,
            end_vertex=hi,
            row=csr.row[lo : hi + 1] - csr.row[lo],
            col=csr.col[csr.row[lo] : csr.row[hi]],
            val=None if csr.val is None else csr.val[csr.row[lo] : csr.row[hi]],
        )
        ells.append(csr_to_ell(sub, max_width=ell_max_width))
        sources = np.unique(sub.col)
        blooms.append(BloomFilter.build(
            sources, num_bits=BloomFilter.sized_for(sources.size)))
    R = max(((e.shape[0] + SUBLANE - 1) // SUBLANE) * SUBLANE for e in ells)
    W = max(e.shape[1] for e in ells)
    cols = np.full((num_devices, R, W), -1, dtype=np.int32)
    vals = np.zeros((num_devices, R, W), dtype=np.float32)
    row_map = np.zeros((num_devices, R), dtype=np.int32)
    for d, e in enumerate(ells):
        r, w = e.shape
        cols[d, :r, :w] = e.cols
        vals[d, :r, :w] = e.vals
        row_map[d, :r] = e.row_map
    out_deg = np.bincount(src, minlength=n_pad).astype(np.int64)
    return DeviceShardedGraph(
        num_vertices=int(num_vertices), padded_num_vertices=n_pad,
        num_edges=len(src), cols=cols, vals=vals,
        row_map=row_map, out_deg=out_deg, rows_per_device=per, blooms=blooms,
    )


class DistributedVSW:
    """1-D distributed VSW prototype: the WHOLE graph resident on the lanes.

    The minimal multi-device reference (and oracle target for
    ``ShardedVSWEngine``): ``partition_for_mesh`` places every edge on its
    owner lane up front, so an iteration is one gather -> SpMV -> post per
    lane, the intervals gathered back into the replicated source array and
    the changed counts summed — no disk, no cache, no prefetch.

    ``devices`` is a list of one device per partition of ``graph`` (or a
    spec ``make_data_devices`` expands; default ``"cuda"``).  ``config`` (an
    ``EngineConfig``) shares the session-level tuning surface.  Honored
    fields: ``use_kernel`` (SpMV backend) and ``selective_threshold`` —
    below it, the replicated per-device Bloom filters
    (``DeviceShardedGraph.blooms``) gate which lanes compute at all (a
    skipped lane keeps its interval unchanged).  The I/O fields
    (``cache_*``, ``prefetch_depth``, ``preload``) do not apply: there is no
    storage path here; ``GraphSession`` with ``num_devices > 1`` runs the
    streaming engine.

    Padding: vertex ids in ``[num_vertices, padded_num_vertices)`` exist
    only to even the intervals.  They start at zero (never set by
    ``program.init``, which sees the TRUE ``n``), are masked out of the
    changed count and sliced off the returned values.
    """

    def __init__(self, graph: DeviceShardedGraph,
                 program: VertexProgram | str,
                 devices: Sequence | torch.device | str = "cuda",
                 use_kernel: bool | str = "auto",
                 config: EngineConfig | None = None):
        if isinstance(program, str):
            program = get_app(program)
        self.g = graph
        self.program = program
        self.num_devices = graph.cols.shape[0]
        self.devices = make_data_devices(self.num_devices, devices)
        self.device = self.devices[0]
        self.selective_threshold = EngineConfig.selective_threshold
        if config is not None:
            use_kernel = config.use_kernel
            self.selective_threshold = config.selective_threshold
        self.use_kernel = use_kernel
        self.n = graph.num_vertices
        self.n_pad = graph.padded_num_vertices
        self.per = graph.rows_per_device
        self._edges = [
            tuple(torch.from_numpy(np.ascontiguousarray(a[d])).to(dev)
                  for a in (graph.cols, graph.vals, graph.row_map))
            for d, dev in enumerate(self.devices)]
        self._out_deg = torch.from_numpy(
            graph.out_deg.astype(np.float32)).to(self.device)
        # lanes that folded their edges in the last run (one SpMV each):
        # iterations x lanes, less the Bloom-skipped ones
        self.lane_sweeps = 0

    def _schedule_flags(self, active_ids: np.ndarray | None,
                        active_ratio: float) -> np.ndarray:
        """Replicated-Bloom lane schedule (host-side, deterministic)."""
        if active_ids is None or active_ratio >= self.selective_threshold:
            return np.ones(self.num_devices, dtype=bool)
        return np.array([b.might_contain_any(active_ids)
                         for b in self.g.blooms], dtype=bool)

    def _iterate(self, src: torch.Tensor, flags: np.ndarray):
        """One iteration -> (new src [n_pad], changed [n_pad], count)."""
        program, n, per = self.program, self.n, self.per
        x = program.gather_transform(src, self._out_deg)
        news, masks, count = [], [], 0
        for d, dev in enumerate(self.devices):
            lo = d * per
            old = src[lo:lo + per].to(dev)
            if flags[d]:
                cols, vals, row_map = self._edges[d]
                seg = ell_spmv(x.to(dev), cols, vals, row_map, cols.shape[0],
                               program.semiring, use_kernel=self.use_kernel)
                new = program.post(seg[:per], old, n).to(src.dtype)
            else:
                new = old  # Bloom-skipped lane: its interval stays verbatim
            # padding rows (ids >= n) never count as changed
            real = torch.arange(lo, lo + per, device=dev) < n
            mask = program.changed(new, old) & real
            news.append(new.to(self.device))
            masks.append(mask.to(self.device))
            count += int(mask.sum())
        return torch.cat(news), torch.cat(masks), count

    def run(self, max_iters: int = 100) -> tuple[np.ndarray, int]:
        n = self.n
        values, active = self.program.init(n, None, self.g.out_deg[:n])
        src = torch.from_numpy(np.pad(values.astype(np.float32),
                                      (0, self.n_pad - n))).to(self.device)
        active_ids = np.nonzero(np.asarray(active, dtype=bool))[0]
        active_ratio = active_ids.size / max(n, 1)
        it_done = self.lane_sweeps = 0
        for it in range(1, max_iters + 1):
            flags = self._schedule_flags(active_ids, active_ratio)
            if not flags.any():
                break  # every lane Bloom-skipped: nothing can change
            src, changed, count = self._iterate(src, flags)
            self.lane_sweeps += int(flags.sum())
            it_done = it
            if count == 0:
                break
            active_ids = np.nonzero(changed[:n].cpu().numpy())[0]
            active_ratio = active_ids.size / max(n, 1)
        return src[:n].cpu().numpy(), it_done


def _device_grid(devices, home: torch.device, D: int, S: int):
    """``devices`` as a D x S grid of resolved devices (None: all ``home``)."""
    if devices is None:
        return [[home] * S for _ in range(D)]
    grid = [[resolve_device(dev) for dev in row] for row in devices]
    if len(grid) != D or any(len(row) != S for row in grid):
        raise ValueError(f"devices must be a {D} x {S} grid (destination "
                         f"blocks x source ranges), got "
                         f"{[len(row) for row in grid]}")
    return grid


def spmv_2d(x: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
            row_map: torch.Tensor, semiring: str, devices=None,
            use_kernel: bool | str = "auto",
            extents: torch.Tensor | None = None) -> torch.Tensor:
    """2-D partitioned SpMV: D destination blocks x S source ranges.

    ``cols``/``vals`` are ``[D, S, R, W]`` ELL tiles whose cols are LOCAL
    indices into the tile's source block ``x[s*n/S : (s+1)*n/S]`` (``n``
    must divide by S); ``row_map`` is ``[D, S, R]``.  Tile (d, s) runs on
    ``devices[d][s]`` (a D x S grid; default: where ``x`` lies): the
    ``ell_gather_fold`` kernel (B4) folds it against its source block, then
    a segment combine yields its ``[R]`` partial.  The S partials of a
    destination block combine by a sum for plus semirings and an
    elementwise min or max otherwise (the reference's psum / pmin over the
    source axis).  ``extents`` ``[D, S, R]`` (``ell_row_extents(cols)``,
    int32, on ``cols``' device, built once with the tiles) let B4 read each
    row only up to its last valid slot.  Returns ``[D, R]`` on ``x``'s
    device.
    """
    D, S, R = cols.shape[:3]
    n = x.shape[0]
    if n % S:
        raise ValueError(f"x has {n} entries, not a multiple of the {S} "
                         "source ranges")
    vb = n // S
    if extents is not None:
        check_extents(extents, cols)
    sem = SEMIRINGS[semiring]
    grid = _device_grid(devices, x.device, D, S)
    out = []
    for d in range(D):
        acc = None
        for s in range(S):
            dev = grid[d][s]
            partial = ell_gather_fold(
                x[s * vb:(s + 1) * vb].to(dev), cols[d, s].to(dev),
                vals[d, s].to(dev), semiring, use_kernel=use_kernel,
                extents=None if extents is None else extents[d, s].to(dev))
            seg = segment_combine(partial.reshape(-1), row_map[d, s].to(dev),
                                  R, semiring).to(x.device)
            if acc is None:
                acc = seg
            elif sem.is_plus:
                acc = acc + seg
            else:
                acc = (torch.maximum if sem.is_max else torch.minimum)(acc, seg)
        out.append(acc)
    return torch.stack(out)
