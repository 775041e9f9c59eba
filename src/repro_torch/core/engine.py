"""VSW engine: the paper's Algorithm 2 on a torch device.

Faithful structure:
  * ``SrcVertexArray`` / ``DstVertexArray`` live on the device for the whole
    run (vertices never touch disk until the final checkpoint) — VSW's core
    claim;
  * edges stream shard-by-shard through the compressed cache (host tier) to
    the device; each shard updates exactly its destination interval, so the
    update is single-writer and lock/atomic-free.  The stream runs through a
    ``ShardPipeline``: with ``config.prefetch_depth > 0`` the next shards'
    disk reads, decompression and host->device copies happen on a background
    thread (and, on CUDA, its own stream) while the current shard's SpMV runs
    (paper §2.3's overlap; depth 0 = the synchronous path);
  * after each iteration the active-vertex set is extracted; when
    ``active_ratio < selective_threshold`` (paper: 0.001) the per-shard Bloom
    filters gate shard loading (Algorithm 2 line 5).

A ``BatchedVertexProgram`` runs K frontiers through the same loop: values
are ``[n_pad, K]``, each shard is read once for all K columns
(``ell_spmv_batch``), shards are scheduled over the union of the columns'
frontiers, and the run returns a ``BatchRunResult`` with per-column
iteration counts.

Engines are normally built by ``repro_torch.session.GraphSession``, which
owns the store, ONE ``CompressedShardCache`` and the device-resident degree
array shared by every application.  Tuning lives in the frozen
``EngineConfig``.

Fault tolerance: the VSW invariant makes engine state tiny (2C|V| + cursor);
``checkpoint_every`` snapshots (values, active, iteration) with atomic
rename, in the reference package's npz format, and ``run(resume=True)``
restarts from the latest snapshot — written by either package.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import warnings
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.apps import BatchedVertexProgram, VertexProgram
from repro_torch.core.cache import CompressedShardCache
from repro_torch.core.pipeline import ShardPipeline
from repro_torch.core.shards import ELLShard
from repro_torch.graph.source import ConcurrentMutationError, ShardSource
from repro_torch.kernels.spmv.ops import (USE_KERNEL_CHOICES, ell_spmv,
                                          ell_spmv_batch)
from repro_torch.state import state_from_numpy, state_to_numpy

_VALID_CACHE_MODES = (0, 1, 2, 3, 4)


def resolve_device(device: torch.device | str) -> torch.device:
    """The device a session or engine runs on; CUDA must be present when
    asked for — nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def pad_to_device(arr: np.ndarray, n_pad: int,
                  device: torch.device) -> torch.Tensor:
    """[n] (or [n, K]) host array -> [n_pad] (or [n_pad, K]) float32 on
    ``device``, zero-padded."""
    padded = np.zeros((n_pad,) + arr.shape[1:], dtype=np.float32)
    padded[: arr.shape[0]] = arr
    return torch.from_numpy(padded).to(device)


def stage_shard(shard: ELLShard, device: torch.device,
                copy_stream: "torch.cuda.Stream | None" = None):
    """One shard's arrays on ``device``.

    -> ``(cols, vals, row_map, (scale, zero), ready)``.  On CUDA each array
    goes through pinned host memory and ``non_blocking`` copies on
    ``copy_stream`` (the prefetch stream, depth > 0) or the current stream
    of ``device`` (depth 0); ``ready`` is an event recorded after the
    copies, which the sweep makes its compute stream wait on.  ``ready`` is
    None on the CPU.
    """
    arrays = [torch.from_numpy(a)
              for a in (shard.cols, shard.vals, shard.row_map)]
    qparams = (shard.val_scale, shard.val_zero)
    if device.type != "cuda":
        return (*arrays, qparams, None)
    stream = copy_stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        staged = [a.pin_memory().to(device, non_blocking=True)
                  for a in arrays]
        ready = torch.cuda.Event()
        ready.record(stream)
    return (*staged, qparams, ready)


def _store_epoch(store) -> int:
    """Graph epoch of a store; frozen backends (no ``epoch``) sit at 0."""
    fn = getattr(store, "epoch", None)
    return int(fn()) if callable(fn) else 0


def _env(name: str, default, cast):
    raw = os.environ.get(name)
    if raw is None or raw == "":  # unset/empty (CI matrix legs) -> default
        return default
    try:
        return cast(raw)
    except (TypeError, ValueError):
        warnings.warn(f"ignoring unparseable {name}={raw!r}", RuntimeWarning)
        return default


def _cast_mode(raw: str):
    return raw if raw in ("auto", "adaptive") else int(raw)


def _cast_tristate(raw: str):
    low = raw.lower()
    if low == "auto":
        return "auto"
    return low in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Validated, immutable engine tuning.

    ``from_env()`` reads ``GRAPHMP_*`` environment overrides; ``replace()``
    derives per-run variants without mutating the shared default.  Fields
    (env var in parentheses) are those of the reference package's
    ``EngineConfig``, with ``use_kernel`` in place of ``use_pallas``:

    cache_mode (``GRAPHMP_CACHE_MODE``):
        ``"auto"``/``"adaptive"`` — the two-tier adaptive edge cache
        (default); an int 0-4 — the paper's static §2.4.2 modes (0 = no
        cache, 1 = raw arrays, 2-4 = zstd levels 1/3/9).
    cache_budget_bytes (``GRAPHMP_CACHE_BUDGET``, legacy alias
    ``GRAPHMP_CACHE_BUDGET_BYTES``):
        Strict host-byte budget for the edge cache, covering both tiers;
        0 means "no application cache" (degrades to mode 0).
    cache_hot_fraction (``GRAPHMP_CACHE_HOT_FRACTION``):
        Adaptive cache only: fraction of the budget the hot (decompressed)
        tier may occupy, in (0, 1].
    cache_promote_after (``GRAPHMP_CACHE_PROMOTE_AFTER``):
        Adaptive cache only: accesses (including the admitting miss) after
        which a cold shard becomes a promotion candidate (>= 1).
    selective_threshold (``GRAPHMP_SELECTIVE_THRESHOLD``):
        Active-vertex ratio below which Bloom-filter selective scheduling
        kicks in (paper: 0.001); negative disables it.
    use_kernel (``GRAPHMP_USE_KERNEL``):
        SpMV backend: ``"auto"`` launches the CUDA kernels for CUDA tensors
        and runs the plain torch version on the CPU; True insists on the
        kernels; False runs the plain version everywhere.
    fused_gather (no env var):
        True (default, the production path): the SpMV kernel gathers the
        frontier itself (``ell_spmv_fused``).  False exists only so that
        tests and ``chip_smoke.py`` can drive the ``ell_fold`` kernel on the
        main path (torch gathers ``x[cols]``, the kernel folds it) and hold
        it to identical results; it is slower and not a tuning option.
    preload (``GRAPHMP_PRELOAD``):
        Pin every shard through the cache at engine construction.
    prefetch_depth (``GRAPHMP_PREFETCH``):
        Shards fetched ahead on a background thread (0 = synchronous,
        1 = double buffering).
    num_devices (``GRAPHMP_DEVICES``):
        Device lanes one VSW iteration drives.  Above 1, ``GraphSession``
        runs ``core.distributed.ShardedVSWEngine``: each lane owns a
        contiguous run of shards, its own cache partition, prefetch lane and
        CUDA stream (``dist.context.make_data_devices`` says which device
        each lane is on).
    """

    cache_mode: int | str = "auto"
    cache_budget_bytes: int = 1 << 30
    cache_hot_fraction: float = 0.5
    cache_promote_after: int = 2
    selective_threshold: float = 1e-3
    use_kernel: bool | str = "auto"
    fused_gather: bool = True
    preload: bool = False
    prefetch_depth: int = 0
    num_devices: int = 1

    def __post_init__(self):
        mode = self.cache_mode
        if not (mode in ("auto", "adaptive")
                or (isinstance(mode, int)
                    and not isinstance(mode, bool)
                    and mode in _VALID_CACHE_MODES)):
            raise ValueError(
                f"cache_mode must be 'auto', 'adaptive' or one of "
                f"{_VALID_CACHE_MODES}, got {mode!r}")
        if not isinstance(self.cache_budget_bytes, int) \
                or isinstance(self.cache_budget_bytes, bool) \
                or self.cache_budget_bytes < 0:
            raise ValueError(
                f"cache_budget_bytes must be an int >= 0 (0 = no cache), "
                f"got {self.cache_budget_bytes!r}")
        if not isinstance(self.cache_hot_fraction, (int, float)) \
                or isinstance(self.cache_hot_fraction, bool) \
                or not 0.0 < self.cache_hot_fraction <= 1.0:
            raise ValueError(
                f"cache_hot_fraction must be in (0, 1], "
                f"got {self.cache_hot_fraction!r}")
        if not isinstance(self.cache_promote_after, int) \
                or isinstance(self.cache_promote_after, bool) \
                or self.cache_promote_after < 1:
            raise ValueError(
                f"cache_promote_after must be an int >= 1, "
                f"got {self.cache_promote_after!r}")
        if not np.isfinite(self.selective_threshold):
            raise ValueError(
                f"selective_threshold must be finite, "
                f"got {self.selective_threshold!r}")
        if self.use_kernel not in USE_KERNEL_CHOICES:
            raise ValueError(
                f"use_kernel must be True, False or 'auto', "
                f"got {self.use_kernel!r}")
        if not isinstance(self.fused_gather, bool):
            raise ValueError(
                f"fused_gather must be a bool, got {self.fused_gather!r}")
        if not isinstance(self.prefetch_depth, int) \
                or isinstance(self.prefetch_depth, bool) \
                or self.prefetch_depth < 0:
            raise ValueError(
                f"prefetch_depth must be a non-negative int, "
                f"got {self.prefetch_depth!r}")
        if not isinstance(self.num_devices, int) \
                or isinstance(self.num_devices, bool) \
                or self.num_devices < 1:
            raise ValueError(
                f"num_devices must be an int >= 1, got {self.num_devices!r}")

    @classmethod
    def from_env(cls, **overrides) -> "EngineConfig":
        """Defaults with GRAPHMP_* environment overrides applied underneath
        explicit keyword overrides."""
        budget_default = _env("GRAPHMP_CACHE_BUDGET_BYTES",  # legacy alias
                              cls.cache_budget_bytes, int)
        base = dict(
            cache_mode=_env("GRAPHMP_CACHE_MODE", cls.cache_mode, _cast_mode),
            cache_budget_bytes=_env("GRAPHMP_CACHE_BUDGET",
                                    budget_default, int),
            cache_hot_fraction=_env("GRAPHMP_CACHE_HOT_FRACTION",
                                    cls.cache_hot_fraction, float),
            cache_promote_after=_env("GRAPHMP_CACHE_PROMOTE_AFTER",
                                     cls.cache_promote_after, int),
            selective_threshold=_env("GRAPHMP_SELECTIVE_THRESHOLD",
                                     cls.selective_threshold, float),
            use_kernel=_env("GRAPHMP_USE_KERNEL", cls.use_kernel,
                            _cast_tristate),
            preload=_env("GRAPHMP_PRELOAD", cls.preload,
                         lambda r: _cast_tristate(r) is True),
            prefetch_depth=_env("GRAPHMP_PREFETCH", cls.prefetch_depth, int),
            num_devices=_env("GRAPHMP_DEVICES", cls.num_devices, int),
        )
        base.update(overrides)
        return cls(**base)

    def replace(self, **changes) -> "EngineConfig":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class IterationStats:
    iteration: int
    seconds: float
    active_ratio: float
    shards_processed: int
    shards_skipped: int
    disk_bytes: int
    cache_hit_ratio: float
    selective_enabled: bool
    edges_processed: int = 0    # sum of nnz over the shards actually run
    stall_seconds: float = 0.0  # time the compute loop waited on shard I/O
    fetch_seconds: float = 0.0  # fetch+stage time (overlapped when prefetching)
    decode_seconds_saved: float = 0.0  # decompression cost hot-tier hits skipped
    # multi-device runs only (empty tuples otherwise): per-lane splits of the
    # aggregates above, one entry per lane, summing to the aggregate
    device_disk_bytes: tuple = ()
    device_stall_seconds: tuple = ()
    device_fetch_seconds: tuple = ()


@dataclasses.dataclass
class RunResult:
    """What one application run produced.

    ``values`` holds one float per vertex (ranks for PageRank, distances
    for SSSP/BFS, component ids for CC) as a numpy array; ``iterations`` is
    how many sweeps ran, ``converged`` whether the frontier emptied before
    ``max_iters``, and ``history`` one ``IterationStats`` per iteration.
    ``total_seconds``/``edges_per_second`` aggregate it.
    """

    values: np.ndarray
    iterations: int
    history: list[IterationStats]
    converged: bool
    # graph epoch pinned at run start (0 = frozen store) and program tag
    epoch: int = 0
    tag: str | None = None

    @property
    def total_seconds(self) -> float:
        return sum(h.seconds for h in self.history)

    @property
    def total_edges_processed(self) -> int:
        return sum(h.edges_processed for h in self.history)

    def edges_per_second(self) -> float:
        """Throughput over edges actually processed (skipped shards are
        weighted by their own nnz, so selective runs report honest rates)."""
        return self.total_edges_processed / max(self.total_seconds, 1e-9)


@dataclasses.dataclass
class BatchRunResult(RunResult):
    """Result of a batched (multi-frontier) run: ``values`` is [n, K].

    ``iterations``/``history``/``converged`` describe the shared sweep;
    ``column_iterations[k]`` counts only the iterations column k entered with
    a non-empty frontier (its honest cost — a landmark that converged in 4
    hops does not get billed for the 40-hop straggler's sweeps).  The counts
    are checkpointed, so they span resume boundaries even though ``history``
    only covers the current run.
    """

    column_iterations: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=np.int64))
    column_converged: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, dtype=bool))

    @property
    def num_columns(self) -> int:
        return self.values.shape[1]

    def column(self, k: int) -> RunResult:
        """Per-column view as a plain RunResult.

        ``iterations`` is the lifetime sweep count (spans resumes);
        ``history`` covers only this run, truncated to the iterations the
        column was live for here.  Frontiers only shrink, so a column live
        at a resume point was live for the entire pre-resume prefix —
        lifetime count minus the resume offset is its in-run live count.
        """
        iters = int(self.column_iterations[k])
        pre = self.history[0].iteration if self.history else 0
        return RunResult(values=self.values[:, k], iterations=iters,
                         history=self.history[: max(0, iters - pre)],
                         converged=bool(self.column_converged[k]),
                         epoch=self.epoch)

    def columns(self) -> list[RunResult]:
        return [self.column(k) for k in range(self.num_columns)]


class VSWEngine:
    """One vertex program bound to a graph store (Algorithm 2 executor).

    Normally built by ``GraphSession.engine``/``run``; ``VSWEngine(store,
    program, config, device=...)`` builds a private cache.
    """

    def __init__(
        self,
        store: ShardSource,
        program: VertexProgram,
        config: EngineConfig | None = None,
        *,
        device: torch.device | str = "cuda",
        cache: CompressedShardCache | None = None,
        vertex_info: tuple[np.ndarray, np.ndarray] | None = None,
        blooms: list | None = None,
        out_deg_dev: torch.Tensor | None = None,
        n_pad: int | None = None,
        graph_epoch: int | None = None,
        observers: list | None = None,
    ):
        self.config = config or EngineConfig()
        self.device = resolve_device(device)
        self.store = store
        self.program = program
        self.batched = isinstance(program, BatchedVertexProgram)
        self.cache = cache if cache is not None else CompressedShardCache(
            store, mode=self.config.cache_mode,
            budget_bytes=self.config.cache_budget_bytes,
            hot_fraction=self.config.cache_hot_fraction,
            promote_after=self.config.cache_promote_after)
        # telemetry taps: callables invoked with each IterationStats as it
        # is produced (GraphSession shares ONE list across all its engines).
        # Observer failures are swallowed — monitoring must never alter or
        # abort a computation.
        self.observers: list = observers if observers is not None else []
        self.selective_threshold = self.config.selective_threshold
        self.n = store.num_vertices
        # graph epoch the degree/bloom/meta arrays below were read at; runs
        # pin it (no store of this package moves past it: mutable stores
        # are ROADMAP A5b)
        if graph_epoch is not None:
            self._graph_epoch = int(graph_epoch)
        else:
            self._graph_epoch = _store_epoch(store) if vertex_info is None else 0
        self.in_deg, self.out_deg = (vertex_info if vertex_info is not None
                                     else store.read_vertex_info())
        self.blooms = blooms if blooms is not None else store.read_all_blooms()
        self.P = store.num_shards
        shard_meta = store.properties["shards"]
        self._shard_nnz = [int(m.get("nnz", 0)) for m in shard_meta]
        self.max_rows = max((m["rows"] for m in shard_meta), default=8)
        # pad the vertex arrays so every [start, start + R) slice is in bounds
        self.n_pad = n_pad if n_pad is not None else self.n + self.max_rows
        self._out_deg_dev = (
            out_deg_dev if out_deg_dev is not None
            else pad_to_device(self.out_deg, self.n_pad, self.device))
        self._preloaded: dict[int, ELLShard] = {}
        if self.config.preload:
            for p in range(self.P):
                self._preloaded[p] = self._fetch_shard(p)
        # ALL shard consumption goes through the pipeline — depth 0 is the
        # synchronous path, depth >= 1 prefetches + stages on a worker thread
        # (the sharded engine builds one lane per device instead and leaves
        # self._pipeline as None)
        self._pipeline = self._make_pipeline()
        self.last_result: RunResult | None = None
        # serializes run() calls on this engine: concurrent clients sharing
        # one engine run back-to-back instead of interleaving pipeline stats
        # and per-iteration disk accounting
        self._run_lock = threading.Lock()

    @classmethod
    def from_session(cls, session, program: VertexProgram,
                     config: EngineConfig | None = None) -> "VSWEngine":
        """Build an engine that shares the session's cache + degree arrays."""
        config = config or session.config
        return cls(
            session.store, program, config,
            device=session._lanes(config.num_devices),
            cache=session.cache,
            vertex_info=(session.in_deg, session.out_deg),
            blooms=session.blooms,
            out_deg_dev=session.out_deg_dev,
            n_pad=session.n_pad,
            graph_epoch=session._graph_epoch,
            observers=session.iteration_observers,
        )

    # ------------------------------------------------------------------
    @staticmethod
    def _tag_for(program) -> str:
        """Program identity recorded in checkpoints: name + frontier ids."""
        return f"{program.name}:{tuple(program.sources)}"

    def _check_program(self, program):
        """A run-time program substitute must be engine-compatible: equal
        non-None ``jit_signature`` guarantees it computes exactly this
        engine's device functions (only host-side init / sources /
        checkpoint tags differ).

        The ``__code__`` comparison is a tripwire for a broken claim: fresh
        instances from the same factory (and rename-only
        ``dataclasses.replace`` derivatives like bfs) share code objects for
        their device callables, but a program that kept an inherited
        signature while overriding gather/post/changed does not."""
        if program is None or program is self.program:
            return self.program
        sig = getattr(program, "jit_signature", None)
        if sig is None or sig != self.program.jit_signature:
            raise ValueError(
                f"program {program.name!r} (jit_signature={sig!r}) is not "
                f"compatible with this engine's {self.program.name!r} "
                f"(jit_signature={self.program.jit_signature!r})")
        for attr in ("gather_transform", "post", "changed"):
            mine = getattr(getattr(self.program, attr), "__code__", None)
            theirs = getattr(getattr(program, attr), "__code__", None)
            if mine is not theirs:
                raise ValueError(
                    f"program {program.name!r} claims jit_signature {sig!r} "
                    f"but its {attr} differs from this engine's — a "
                    f"dataclasses.replace() that overrides device callables "
                    f"must also replace jit_signature")
        return program

    def _fetch_shard(self, p: int) -> ELLShard:
        """Raw cache fetch (no preload shortcut): the seam that decides
        which cache a shard comes from (the sharded engine's cache routes
        it to the owning lane's partition)."""
        return self.cache.get(p)

    def _make_pipeline(self):
        """Build the shard stream consumed by ``_sweep``."""
        # host->device copies of prefetched shards run on their own stream
        # so they overlap the SpMV on the compute stream
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda"
                             and self.config.prefetch_depth > 0 else None)
        return ShardPipeline(
            self._get_shard, depth=self.config.prefetch_depth,
            stage=self._stage, nbytes=ELLShard.decoded_nbytes)

    def _get_shard(self, p: int) -> ELLShard:
        if p in self._preloaded:
            return self._preloaded[p]
        return self._fetch_shard(p)

    def _stage(self, shard: ELLShard):
        """Host->device staging; runs on the prefetch thread when depth > 0
        (see ``stage_shard``)."""
        return stage_shard(shard, self.device, self._copy_stream)

    def _schedule(self, active_ids: np.ndarray | None,
                  active_ratio: float) -> tuple[list[int], bool]:
        """Algorithm 2 line 5: all shards, unless selective scheduling kicks in."""
        if (
            active_ids is None
            or active_ratio >= self.selective_threshold
        ):
            return list(range(self.P)), False
        keep = [p for p in range(self.P)
                if self.blooms[p].might_contain_any(active_ids)]
        return keep, True

    # ------------------------------------------------------------------
    def _io_marks(self):
        """Snapshot of the cache/pipeline counters an iteration deltas
        against (paired with ``_io_stats``)."""
        cs, ps = self.cache.stats, self._pipeline.stats
        return (cs.disk_bytes, cs.hits, cs.misses, cs.decode_seconds_saved,
                ps.stall_seconds, ps.fetch_seconds)

    def _io_stats(self, marks) -> dict:
        """IterationStats I/O fields as deltas against ``marks``."""
        disk0, hits0, misses0, saved0, stall0, fetch0 = marks
        cs, ps = self.cache.stats, self._pipeline.stats
        d_hits = cs.hits - hits0
        d_total = d_hits + cs.misses - misses0
        return dict(
            disk_bytes=cs.disk_bytes - disk0,
            cache_hit_ratio=d_hits / d_total if d_total else 0.0,
            stall_seconds=ps.stall_seconds - stall0,
            fetch_seconds=ps.fetch_seconds - fetch0,
            decode_seconds_saved=cs.decode_seconds_saved - saved0,
        )

    def _sweep(self, program, x: torch.Tensor, src: torch.Tensor, aux, it,
               schedule, epoch_check) -> tuple[torch.Tensor, torch.Tensor]:
        """One edge sweep: stream the scheduled shards, fold each into the
        destination array.  Returns ``(new values [n_pad(, K)],
        changed [n(, K)])``.  ``aux`` (a device [n_pad, K] tensor or None)
        and ``it`` (a device int32 scalar) reach a batched ``post`` only."""
        n = self.n
        dst = src.clone()
        for _p, shard, staged in self._pipeline.stream(schedule,
                                                       check=epoch_check):
            start, new = self._fold_shard(program, x, src, aux, it, shard,
                                          staged)
            dst[start:start + new.shape[0]] = new
        return dst, program.changed(dst[:n], src[:n])

    def _fold_shard(self, program, x: torch.Tensor, src: torch.Tensor, aux,
                    it, shard: ELLShard, staged) -> tuple[int, torch.Tensor]:
        """SpMV + post of one staged shard, on the current stream of the
        device its arrays lie on.  Returns ``(start, new)``: the new values
        of the shard's destination interval ``[start, start + num_rows)``.

        The reference writes all R rows of the ELL bucket, putting the OLD
        values back into rows [num_rows, R).  Those rows belong to later
        intervals (or the padding past n), so writing only the interval is
        equivalent."""
        cfg = self.config
        cols, vals, row_map, qparams, ready = staged
        if ready is not None:
            compute = torch.cuda.current_stream(cols.device)
            compute.wait_event(ready)
            # the copies were allocated on the staging stream: tell the
            # caching allocator the compute stream reads them, so their
            # memory is not handed out again before the kernel is done
            for t in (cols, vals, row_map):
                t.record_stream(compute)
        R = cols.shape[0]
        start = shard.start_vertex
        num_rows = shard.end_vertex - start
        spmv = ell_spmv_batch if self.batched else ell_spmv
        seg = spmv(x, cols, vals, row_map, R, program.semiring,
                   use_kernel=cfg.use_kernel, qparams=qparams,
                   fused=cfg.fused_gather)
        old = src[start:start + R]
        if self.batched:
            rows = torch.arange(start, start + R, device=src.device)
            post_args = (seg, old, rows, self.n, None if aux is None
                         else aux[start:start + R])
            if program.wants_iteration:
                post_args += (it,)
            new = program.post(*post_args)
        else:
            new = program.post(seg, old, self.n)
        return start, new[:num_rows].to(src.dtype)

    # ------------------------------------------------------------------
    def iter_run(
        self,
        max_iters: int = 200,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        program: VertexProgram | None = None,
        init_state: tuple[np.ndarray, np.ndarray] | None = None,
    ) -> Iterator[IterationStats]:
        """Generator form of ``run``: yields an IterationStats after every
        iteration (live monitoring), returns the RunResult on exhaustion
        (also stored in ``self.last_result``).  Batched programs return a
        ``BatchRunResult`` with [n, K] values and per-column accounting.

        ``program`` substitutes a compatible program (equal
        ``jit_signature``) for this run only: ``init``/``sources``/
        checkpoint tags come from the substitute.  This is how one engine
        answers e.g. SSSP from any source.

        ``init_state`` replaces ``program.init`` with explicit
        ``(values, active_mask)`` arrays (``[n]``, or ``[n, K]`` for a
        batched program).  Mutually exclusive with ``resume``.

        The run **pins the store's graph epoch at start**: every shard fetch
        asserts the shard has not moved past it, and a concurrent mutation
        raises ``ConcurrentMutationError`` instead of mixing epochs into one
        result."""
        program = self._check_program(program)
        run_epoch = self._graph_epoch
        shard_epoch_fn = getattr(self.store, "shard_epoch", None)
        epoch_check = None
        if shard_epoch_fn is not None:
            def epoch_check(p, _fn=shard_epoch_fn, _pin=run_epoch):
                got = _fn(p)
                if got > _pin:
                    raise ConcurrentMutationError(
                        f"shard {p} is at epoch {got}, newer than the epoch "
                        f"{_pin} this run pinned at start — the graph was "
                        "mutated mid-run")
        if init_state is not None:
            if resume:
                raise ValueError("init_state and resume are mutually "
                                 "exclusive ways to seed a run")
            values, active_mask = init_state
            values = np.asarray(values)
            active_mask = np.asarray(active_mask, dtype=bool)
            want = ((self.n, program.columns) if self.batched
                    else (self.n,))
            if values.shape != want or active_mask.shape != values.shape:
                raise ValueError(
                    f"init_state arrays must both be {list(want)}, got "
                    f"{values.shape} / {active_mask.shape}")
        else:
            values, active_mask = program.init(self.n, self.in_deg,
                                               self.out_deg)
        start_iter = 0
        ck_col_iters = None
        if resume and checkpoint_dir:
            ck = latest_checkpoint(checkpoint_dir)
            if ck is not None:
                if ck[0].shape != values.shape:
                    raise ValueError(
                        f"checkpoint in {checkpoint_dir!r} holds values of "
                        f"shape {ck[0].shape}, but this program expects "
                        f"{values.shape}; it belongs to a different run")
                if ck[4] is not None and ck[4] != self._tag_for(program):
                    raise ValueError(
                        f"checkpoint in {checkpoint_dir!r} was written by "
                        f"{ck[4]!r}, not {self._tag_for(program)!r}; it "
                        f"belongs to a different run")
                values, active_mask, start_iter, ck_col_iters = ck[:4]
        src, _ = state_from_numpy(values, active_mask, self.device, self.n_pad)
        aux = it_dev = col_live = col_iters = None
        if self.batched:
            if program.make_aux is not None:
                aux = pad_to_device(program.make_aux(self.n), self.n_pad,
                                    self.device)
            # per-column frontiers: a shard is skipped only when NO column's
            # active set touches it, so schedule over the union of frontiers
            row_active = active_mask.any(axis=1)
            col_live = active_mask.any(axis=0)
            # batched checkpoints always carry per-column counts
            col_iters = (ck_col_iters.astype(np.int64)
                         if ck_col_iters is not None
                         else np.zeros(program.columns, dtype=np.int64))
        else:
            row_active = active_mask
        active_ids = np.nonzero(row_active)[0]
        active_ratio = active_ids.size / self.n
        history: list[IterationStats] = []
        converged = False

        last_changed = active_mask
        for it in range(start_iter, max_iters):
            t0 = time.time()
            marks = self._io_marks()
            schedule, selective = self._schedule(active_ids, active_ratio)
            if not schedule:
                converged = True
                break
            if self.batched:
                # bill this sweep only to columns still holding a frontier
                col_iters += col_live
                if program.wants_iteration:
                    it_dev = torch.tensor(it, dtype=torch.int32,
                                          device=self.device)
            x = program.gather_transform(src, self._out_deg_dev).contiguous()
            dst, changed_dev = self._sweep(program, x, src, aux, it_dev,
                                           schedule, epoch_check)
            last_changed = changed_dev  # read back only for checkpoints
            if self.batched:
                col_live = changed_dev.any(dim=0).cpu().numpy()
                row_active = changed_dev.any(dim=1).cpu().numpy()
            else:
                row_active = changed_dev.cpu().numpy()  # waits for the sweep
            active_ids = np.nonzero(row_active)[0]
            active_ratio = active_ids.size / self.n
            src = dst
            stats = IterationStats(
                iteration=it,
                seconds=time.time() - t0,
                active_ratio=active_ratio,
                shards_processed=len(schedule),
                shards_skipped=self.P - len(schedule),
                selective_enabled=selective,
                edges_processed=sum(self._shard_nnz[p] for p in schedule),
                **self._io_stats(marks),
            )
            history.append(stats)
            for observe in tuple(self.observers):
                try:
                    observe(stats)
                except Exception:
                    pass  # telemetry must never abort a sweep
            if checkpoint_dir and checkpoint_every \
                    and (it + 1) % checkpoint_every == 0:
                save_checkpoint(checkpoint_dir,
                                *state_to_numpy(src, last_changed, self.n),
                                it + 1, col_iters=col_iters,
                                tag=self._tag_for(program))
            yield stats
            if active_ids.size == 0:
                converged = True
                break

        final, last_changed = state_to_numpy(src, last_changed, self.n)
        if checkpoint_dir:
            # persist the true active mask — a resumed run must see exactly
            # the frontier the interrupted run would have used next (for
            # batched runs this is the full per-column [n, K] frontier)
            save_checkpoint(checkpoint_dir, final, last_changed,
                            len(history) + start_iter, col_iters=col_iters,
                            tag=self._tag_for(program))
        if self.batched:
            # global convergence (empty union frontier / empty schedule)
            # implies no column can ever update again
            result: RunResult = BatchRunResult(
                values=final, iterations=len(history), history=history,
                converged=converged, epoch=run_epoch,
                tag=self._tag_for(program), column_iterations=col_iters,
                column_converged=~col_live | converged)
        else:
            result = RunResult(values=final, iterations=len(history),
                               history=history, converged=converged,
                               epoch=run_epoch, tag=self._tag_for(program))
        self.last_result = result
        return result

    def run(
        self,
        max_iters: int = 200,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 0,
        resume: bool = False,
        program: VertexProgram | None = None,
        init_state: tuple[np.ndarray, np.ndarray] | None = None,
    ) -> RunResult:
        # the lock serializes whole runs; iter_run itself stays lock-free
        # because a generator holding a lock across yields could deadlock
        # its consumer
        with self._run_lock:
            gen = self.iter_run(max_iters=max_iters,
                                checkpoint_dir=checkpoint_dir,
                                checkpoint_every=checkpoint_every,
                                resume=resume, program=program,
                                init_state=init_state)
            while True:
                try:
                    next(gen)
                except StopIteration as stop:
                    return stop.value


# ---------------------------------------------------------------------------
# checkpoints: the reference package's npz format, byte for byte
def save_checkpoint(ckpt_dir: str, values: np.ndarray, active: np.ndarray,
                    iteration: int, col_iters: np.ndarray | None = None,
                    tag: str | None = None) -> None:
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".tmp_ckpt_{iteration:06d}.npz"
    payload = dict(values=values, active=active, iteration=np.int64(iteration))
    if col_iters is not None:
        # batched runs: per-column sweep counts survive the interruption
        payload["col_iters"] = np.asarray(col_iters, dtype=np.int64)
    if tag is not None:
        # program identity (name + frontier ids): resume refuses state from
        # a different program or source set
        payload["tag"] = np.asarray(tag)
    np.savez(tmp, **payload)
    os.replace(tmp, d / f"ckpt_{iteration:06d}.npz")  # atomic publish
    with open(d / "latest.json.tmp", "w") as f:
        json.dump({"iteration": iteration}, f)
    os.replace(d / "latest.json.tmp", d / "latest.json")
    # keep-N garbage collection
    cks = sorted(d.glob("ckpt_*.npz"))
    for old in cks[:-3]:
        old.unlink()


def latest_checkpoint(ckpt_dir: str):
    """-> (values, active, iteration, col_iters | None, tag | None) or None."""
    d = Path(ckpt_dir)
    meta = d / "latest.json"
    if not meta.exists():
        return None
    with open(meta) as f:
        it = json.load(f)["iteration"]
    p = d / f"ckpt_{it:06d}.npz"
    if not p.exists():
        return None
    with np.load(p) as z:
        col_iters = z["col_iters"] if "col_iters" in z.files else None
        tag = str(z["tag"]) if "tag" in z.files else None
        return z["values"], z["active"], int(z["iteration"]), col_iters, tag
