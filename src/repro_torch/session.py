"""GraphSession: the entry point for graph analytics on a torch device.

GraphMP's central economics are "preprocess once, serve many applications
from the same shards, with the compressed edge cache absorbing the disk
I/O" (paper §2.2, §2.4.2).  A ``GraphSession`` is the long-lived object
that realises that: it owns the store, exactly ONE
``CompressedShardCache``, the device-resident padded out-degree array, the
per-shard Bloom filters, and a cache of constructed engines.

    from repro_torch.session import GraphSession

    with GraphSession(store_path, cache_budget_bytes=1 << 28) as s:
        pr = s.run("pagerank", max_iters=30)
        d  = s.run("sssp", source=0)          # warm cache: ~no disk reads
        cc = s.run("cc")
        print(s.stats.hit_ratio, s.stats.disk_bytes)

``run_batch`` answers K single-source queries (SSSP/BFS landmarks,
personalized-PageRank seeds) through ONE sweep of the edge shards per
iteration, and ``service()`` wraps the session in a thread-safe
``GraphService`` that coalesces concurrent point queries into such batches:

        dists = s.run_batch("sssp", sources=[0, 17, 4095])
        with s.service(max_batch=16) as svc:
            print(svc.submit("bfs", source=42).result().values[:10])

Runs go to ``device="cuda"`` unless the caller asks for ``device="cpu"``;
without a GPU, a session that asks for one raises.  With
``num_devices=D > 1`` (or ``GRAPHMP_DEVICES``) every engine is a
``ShardedVSWEngine`` over D device lanes and the edge cache is split into D
partitions under the one budget; ``device`` then names the lanes, as
``dist.context.make_data_devices`` reads it (``"cuda"``: one GPU a lane;
a list such as ``["cpu"] * D`` or ``["cuda:0"] * D`` may repeat a device):

        GraphSession(path, num_devices=2, device=["cuda:0", "cuda:0"])

The store is a directory written by ``preprocess_graph``, a packed
``.gmpk`` file (of this package or the reference ``repro`` package: both
formats are shared) or any constructed ``ShardSource``.
``backend="npz" | "packed" | "memory"`` picks the storage layer for a path
(packed: one mmap'd file, zero-copy shard views; a directory is packed into
``packed.gmpk`` on first use).  ``mutable=True`` wraps the store in a
``DeltaGraphStore``: ``apply_mutations`` commits edge edits, and
``run_incremental`` continues a previous fixpoint across them:

        with GraphSession(path, backend="packed", mutable=True) as s:
            d0 = s.run("sssp", source=0)
            s.apply_mutations(inserts=[(3, 7, 0.5)])
            d1 = s.run_incremental("sssp", source=0, prev=d0)
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.apps import (BatchedVertexProgram, DriverProgram,
                                   VertexProgram, get_app, is_incremental)
from repro_torch.core.cache import CompressedShardCache, PartitionedShardCache
from repro_torch.core.distributed import ShardedVSWEngine, assign_shards
from repro_torch.core.engine import (BatchRunResult, EngineConfig,
                                     IterationStats, RunResult, VSWEngine,
                                     _store_epoch, pad_to_device)
from repro_torch.dist.context import make_data_devices
from repro_torch.graph.delta import DeltaGraphStore
from repro_torch.graph.memory import MemoryGraphStore
from repro_torch.graph.packed import (DEFAULT_PACKED_NAME, PackedGraphStore,
                                      is_packed_file, pack_graph)
from repro_torch.graph.source import ShardSource, path_mtime_ns
from repro_torch.graph.storage import GraphStore

BACKENDS = ("npz", "packed", "memory")

# run_batch accepts the single-source names and maps them onto the batched
# program factories (which are also directly addressable by name).
_BATCH_ALIASES = {
    "sssp": "sssp_multi",
    "bfs": "bfs_multi",
    "pagerank": "personalized_pagerank",
    "ppr": "personalized_pagerank",
    "lp": "lp_multi",
    "kcore": "kcore_multi",
    "triangle_count": "triangles_multi",
    "random_walk": "random_walks",
}
# factories whose per-column parameter is not called "sources" (PPR seeds,
# k-core thresholds, triangle-count probe vertices); sources= still works
# for all of them and is rewritten onto the factory's own vocabulary
_BATCH_PARAMS = {
    "personalized_pagerank": "seeds",
    "kcore_multi": "ks",
    "triangles_multi": "vertices",
}


def _resolve_source(store, backend: str | None):
    """Turn (path, backend) into a ShardSource; pass storage objects through."""
    if not isinstance(store, (str, os.PathLike)):
        if backend is not None:
            raise TypeError(
                "backend= only applies when a graph path is given; got a "
                f"storage object ({type(store).__name__}) — pass its path, "
                "or drop backend=")
        return store
    path = Path(store)
    if backend is None:
        backend = "packed" if is_packed_file(path) else "npz"
    if backend == "npz":
        store = GraphStore(path)
        store.properties  # validate up front: clear MissingGraphError, not a
        #                   raw ENOENT from vertex_info.npz deeper in __init__
        return store
    if backend == "packed":
        if path.is_dir():
            # auto-pack (and re-pack after a fresh preprocess): property.json
            # is written last by preprocess_graph, so its mtime dates the store
            packed = path / DEFAULT_PACKED_NAME
            packed_ns = path_mtime_ns(packed)  # -1 when missing
            if packed_ns < 0 or packed_ns <= path_mtime_ns(
                    path / "property.json"):
                pack_graph(GraphStore(path), packed)
            path = packed
        return PackedGraphStore(path)
    if backend == "memory":
        inner = (PackedGraphStore(path) if is_packed_file(path)
                 else GraphStore(path))
        return MemoryGraphStore.from_source(inner)
    raise ValueError(
        f"unknown backend {backend!r}; expected one of {BACKENDS}")


class GraphSession:
    """Long-lived analytics session over one preprocessed graph.

    Parameters
    ----------
    store:
        A path to a preprocessed graph (npz directory or packed ``.gmpk``
        file) or any constructed ``ShardSource``.
    config:
        ``EngineConfig`` shared by every engine the session builds.  When
        omitted it comes from ``EngineConfig.from_env()``; extra keyword
        arguments (``cache_budget_bytes=...``, ``prefetch_depth=...``, ...)
        override single fields.
    max_engines:
        LRU bound on cached engines.
    backend:
        Storage backend for a path: ``"npz"`` (directory of per-shard npz
        files), ``"packed"`` (one mmap'd file with zero-copy shard views; a
        directory path is packed to ``packed.gmpk`` on first use and again
        when its ``property.json`` is newer), or ``"memory"`` (the whole
        graph in RAM).  Default: ``"packed"`` for a packed file, else
        ``"npz"``.
    mutable:
        Wrap the store in a ``DeltaGraphStore`` so ``apply_mutations`` can
        commit edge inserts/deletes/upserts; ``run_incremental`` continues
        a previous result across them, and ``repro_torch.graph.compact``
        folds the deltas back into the base storage.
    device:
        Where values live and the SpMV runs: ``"cuda"`` (default; raises
        without a GPU) or ``"cpu"``.  With ``num_devices > 1``: the device
        lanes (a list of ``num_devices`` devices, or a spec
        ``make_data_devices`` expands); values live on the first.
    """

    def __init__(self, store: ShardSource | str | os.PathLike,
                 config: EngineConfig | None = None, max_engines: int = 16,
                 *, backend: str | None = None, mutable: bool = False,
                 device: torch.device | str | list = "cuda", **overrides):
        self._owns_store = isinstance(store, (str, os.PathLike))
        store = _resolve_source(store, backend)
        if mutable and not isinstance(store, DeltaGraphStore):
            store = DeltaGraphStore(store)
        if config is None:
            config = EngineConfig.from_env(**overrides)
        elif overrides:
            config = config.replace(**overrides)
        self._device_spec = device
        self.devices = make_data_devices(config.num_devices, device)
        self.device = self.devices[0]
        self.store = store
        self.config = config
        if config.num_devices > 1:
            # multi-device sessions partition the ONE edge cache by shard
            # owner: each lane's shards hash into its own
            # CompressedShardCache slice, all under the same global budget
            owner, _ = assign_shards(
                np.asarray(store.intervals),
                [int(m.get("nnz", 0)) for m in store.properties["shards"]],
                config.num_devices)
            self.cache = PartitionedShardCache(
                store, owner, config.num_devices, mode=config.cache_mode,
                budget_bytes=config.cache_budget_bytes,
                hot_fraction=config.cache_hot_fraction,
                promote_after=config.cache_promote_after)
        else:
            self.cache = CompressedShardCache(
                store, mode=config.cache_mode,
                budget_bytes=config.cache_budget_bytes,
                hot_fraction=config.cache_hot_fraction,
                promote_after=config.cache_promote_after)
        # graph epoch the shared arrays below were read at; engines inherit
        # it and re-sync per run when a mutable store moves past it
        self._graph_epoch = _store_epoch(store)
        # shared vertex metadata: read from disk exactly once per session
        self.in_deg, self.out_deg = store.read_vertex_info()
        self.blooms = store.read_all_blooms()
        shard_meta = store.properties["shards"]
        self.max_rows = max((m["rows"] for m in shard_meta), default=8)
        self.n = store.num_vertices
        self.n_pad = self.n + self.max_rows
        # device-resident padded out-degrees, shared by every engine
        self.out_deg_dev = pad_to_device(self.out_deg, self.n_pad,
                                         self.device)
        if max_engines < 1:
            raise ValueError(f"max_engines must be >= 1, got {max_engines}")
        self.max_engines = max_engines
        self._engines: "OrderedDict" = OrderedDict()
        self._engines_lock = threading.RLock()
        # combined [n, K] result of the most recent run_batch (survives
        # engine-cache eviction, unlike engine(...).last_result)
        self.last_batch_result: BatchRunResult | None = None
        # telemetry taps shared (by reference) with every engine this
        # session builds: each entry is called with every IterationStats
        self.iteration_observers: list = []

    # -- engine construction / reuse ------------------------------------
    def _lanes(self, num_devices: int):
        """What an engine of ``num_devices`` runs on: the session's device
        (1) or its device lanes (> 1; a per-run config that asks for
        another lane count expands the session's ``device`` anew)."""
        if num_devices == 1:
            return self.device
        if num_devices == len(self.devices):
            return self.devices
        return make_data_devices(num_devices, self._device_spec)

    def _resolve(self, app, app_kwargs) -> tuple[VertexProgram, object]:
        if isinstance(app, (VertexProgram, BatchedVertexProgram,
                            DriverProgram)):
            if app_kwargs:
                raise TypeError(
                    "application kwargs only apply when dispatching by name; "
                    f"got a VertexProgram plus {sorted(app_kwargs)}")
            program = app
        else:
            program = get_app(app, **app_kwargs)
        if isinstance(program, DriverProgram):
            # host-driven: no engine, so the key is unused
            return program, ("driver", program.name)
        # programs declaring a jit_signature share engines across every
        # parameterization with identical device callables (e.g. ALL sssp
        # sources): the signature is the cache key and the concrete program
        # is handed to run() per call
        sig = getattr(program, "jit_signature", None)
        if sig is not None:
            return program, ("sig", sig)
        if isinstance(app, str):
            return program, ("name", app, tuple(sorted(app_kwargs.items())))
        return program, ("prog", id(program))

    def engine(self, app: str | VertexProgram,
               config: EngineConfig | None = None, **app_kwargs) -> VSWEngine:
        """The session-shared engine for an application (built once per
        (jit_signature or program, config)).  The returned engine's default
        program is rebound to the one just requested, so single-threaded
        ``engine(...).run()`` works; concurrent callers should go through
        ``session.run`` (which pins the program per call) instead."""
        program, prog_key = self._resolve(app, app_kwargs)
        if isinstance(program, DriverProgram):
            raise TypeError(
                f"{program.name!r} is a host-driven application and has no "
                "engine; dispatch it through session.run / run_batch")
        return self._engine_for(program, prog_key, config)

    def _run_target(self, app, app_kwargs, config):
        """(engine, program-to-pin) for one run: signature-keyed engines get
        the resolved program pinned per call; name-keyed engines run their
        own program; host-driven programs have no engine — (None,
        driver)."""
        program, prog_key = self._resolve(app, app_kwargs)
        if isinstance(program, DriverProgram):
            return None, program
        eng = self._engine_for(program, prog_key, config)
        return eng, (program if prog_key[0] == "sig" else None)

    def _engine_for(self, program, prog_key, config) -> VSWEngine:
        key = (prog_key, config or self.config)
        with self._engines_lock:
            eng = self._engines.get(key)
            if eng is None:
                # num_devices > 1: the same run/run_batch/iter_run surface,
                # D lanes per edge sweep
                cls = (ShardedVSWEngine
                       if (config or self.config).num_devices > 1
                       else VSWEngine)
                eng = cls.from_session(self, program, config)
                if prog_key[0] == "prog":
                    # a raw-id key must keep the program alive to stay unique
                    eng._keyed_program = program
                self._engines[key] = eng
                while len(self._engines) > self.max_engines:
                    self._engines.popitem(last=False)  # drop the LRU engine
            else:
                self._engines.move_to_end(key)
                if eng.program is not program and prog_key[0] == "sig":
                    eng._check_program(program)
                    eng.program = program
            return eng

    # -- running --------------------------------------------------------
    def run(self, app: str | VertexProgram, *, max_iters: int = 200,
            checkpoint_dir: str | None = None, checkpoint_every: int = 0,
            resume: bool = False, config: EngineConfig | None = None,
            **app_kwargs) -> RunResult:
        """Run one application to ``max_iters`` or convergence.

        ``app`` is a registered name (``available_apps()``; extra keyword
        arguments go to its factory, e.g. ``run("sssp", source=3)``) or a
        constructed ``VertexProgram``.  ``checkpoint_dir`` /
        ``checkpoint_every`` / ``resume`` snapshot and restart the run;
        ``config`` overrides the session config for this application's
        engine (the edge cache stays shared).  Returns a ``RunResult`` with
        numpy ``values``, ``iterations``, ``converged`` and ``history``.
        Host-driven applications (``triangles``, ``random_walks``) run
        their own loop and take no checkpoint arguments.
        """
        eng, run_program = self._run_target(app, app_kwargs, config)
        if eng is None:  # host-driven application
            return self._run_driver(
                run_program, max_iters=max_iters,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume,
                config=config)
        return eng.run(max_iters=max_iters, checkpoint_dir=checkpoint_dir,
                       checkpoint_every=checkpoint_every, resume=resume,
                       program=run_program)

    def _run_driver(self, program: DriverProgram, *, max_iters,
                    checkpoint_dir, checkpoint_every, resume, config):
        if checkpoint_dir or checkpoint_every or resume:
            raise TypeError(
                f"{program.name!r} is a host-driven application; engine "
                "checkpoint/resume do not apply to it")
        result = program.run(self, max_iters=max_iters, config=config)
        if isinstance(result, BatchRunResult):
            self.last_batch_result = result
        return result

    def iter_run(self, app: str | VertexProgram, *, max_iters: int = 200,
                 checkpoint_dir: str | None = None, checkpoint_every: int = 0,
                 resume: bool = False, config: EngineConfig | None = None,
                 **app_kwargs) -> Iterator[IterationStats]:
        """Streaming form of ``run``: yields an ``IterationStats`` after
        every iteration; the ``RunResult`` is the generator's return value
        (``StopIteration.value``) and ``engine(app).last_result``."""
        eng, run_program = self._run_target(app, app_kwargs, config)
        if eng is None:
            raise TypeError(
                f"{run_program.name!r} is a host-driven application; "
                "iter_run streams engine iterations — use run() for it")
        return eng.iter_run(max_iters=max_iters, checkpoint_dir=checkpoint_dir,
                            checkpoint_every=checkpoint_every, resume=resume,
                            program=run_program)

    def run_batch(self, app: str | BatchedVertexProgram = "sssp", *,
                  sources: Iterable[int] | None = None, max_iters: int = 200,
                  checkpoint_dir: str | None = None, checkpoint_every: int = 0,
                  resume: bool = False, config: EngineConfig | None = None,
                  **app_kwargs) -> list[RunResult]:
        """K single-source queries through ONE sweep of the edge shards.

        Each iteration pays disk + decompression + host-to-device staging
        for a shard once and advances every column against it, so K
        landmark queries cost close to one query's I/O instead of K (paper
        §2.2's amortization, applied across *queries*).

        Parameters
        ----------
        app:
            A single-source name (``"sssp"``/``"bfs"``/``"pagerank"``/
            ``"ppr"`` — the last two become personalized PageRank over the
            given seeds — ``"lp"``, ``"kcore"``, ``"triangle_count"`` or
            ``"random_walk"``), a batched factory name (``"sssp_multi"``,
            ``"lp_multi"``, ``"kcore_multi"``, ``"triangles_multi"``, ...),
            the batched driver ``"random_walks"``, or a
            ``BatchedVertexProgram``.
        sources:
            One frontier vertex per column (for PPR these are the
            ``seeds``, for k-core the thresholds ``ks``, for triangle
            counts the probe ``vertices``; either spelling works).
            Required when dispatching by name.
        max_iters / checkpoint_dir / checkpoint_every / resume / config:
            As in ``run``; checkpoints hold the full [n, K] state and the
            per-column iteration counts, so a resumed batch continues every
            column (in either package: the format is the reference's).

        Returns
        -------
        One ``RunResult`` per source, in order, with honest per-column
        iteration counts (a column is only billed for sweeps it entered
        with a live frontier).  The combined ``BatchRunResult`` ([n, K]
        values, shared history) stays available as
        ``session.last_batch_result`` until the next ``run_batch`` call.
        """
        if isinstance(app, (BatchedVertexProgram, DriverProgram)):
            if sources is not None:
                raise TypeError(
                    "sources= only applies when dispatching by name; the "
                    "BatchedVertexProgram already fixes its frontiers")
            # forward app_kwargs so misuse raises like run() does
            program, prog_key = self._resolve(app, app_kwargs)
        else:
            name = _BATCH_ALIASES.get(app, app)
            param = _BATCH_PARAMS.get(name, "sources")
            if sources is not None:
                if param in app_kwargs:
                    raise TypeError(
                        f"pass sources= or {param}=, not both")
                app_kwargs[param] = tuple(int(s) for s in sources)
            elif param in app_kwargs:
                # the factory's own vocabulary (e.g. seeds= for PPR) works too
                app_kwargs[param] = tuple(int(s) for s in app_kwargs[param])
            else:
                raise TypeError("run_batch needs sources=[...] when "
                                "dispatching by name")
            # signature-keyed dispatch so repeat calls reuse the engine —
            # across DIFFERENT landmark sets of the same K, not just repeats
            # of one set
            try:
                program, prog_key = self._resolve(name, app_kwargs)
            except TypeError as exc:
                if f"unexpected keyword argument {param!r}" in str(exc):
                    # the factory has no frontier parameter at all
                    raise TypeError(
                        f"{name!r} is not a batched application") from None
                raise  # genuine bad kwarg — keep the factory's own message
        if isinstance(program, DriverProgram):
            if not program.batched:
                raise TypeError(f"{app!r} is not a batched application")
            result = self._run_driver(
                program, max_iters=max_iters, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume,
                config=config)
            return result.columns()
        if not isinstance(program, BatchedVertexProgram):
            raise TypeError(f"{app!r} is not a batched application")
        eng = self._engine_for(program, prog_key, config)
        result = eng.run(max_iters=max_iters, checkpoint_dir=checkpoint_dir,
                         checkpoint_every=checkpoint_every, resume=resume,
                         program=program if prog_key[0] == "sig" else None)
        self.last_batch_result = result
        return result.columns()

    def run_many(self, apps: Iterable, **run_kwargs) -> list[RunResult]:
        """Run several applications back-to-back over the shared cache.

        Each item is a registered name, a ``(name, factory_kwargs)`` pair,
        or a ``VertexProgram``; ``run_kwargs`` (``max_iters=...``) apply to
        every run.  Returns results in input order.
        """
        results = []
        for item in apps:
            if isinstance(item, tuple):
                name, kw = item
                results.append(self.run(name, **run_kwargs, **kw))
            else:
                results.append(self.run(item, **run_kwargs))
        return results

    def service(self, config=None, **overrides):
        """A concurrent query service over this session.

        Returns a started ``repro_torch.serve.GraphService`` wrapping this
        session: many client threads ``submit()`` single queries, the
        service coalesces compatible ones into K-column micro-batches served
        by ``run_batch`` through the shared compressed cache, and each
        caller gets its own future/``RunResult``.  ``config`` is a
        ``repro_torch.serve.ServiceConfig``; keyword overrides
        (``max_batch=...``, ``max_wait_ms=...``) adjust single fields.
        The session must outlive the service (close the service first).
        """
        from repro_torch.serve.graph_service import GraphService
        return GraphService(self, config, **overrides)

    # -- mutation / incremental recompute -------------------------------
    def apply_mutations(self, inserts=None, deletes=None,
                        updates=None) -> int:
        """Commit one batch of edge edits to a ``mutable=True`` session.

        ``inserts``/``updates`` (synonyms: both upsert) take ``(src, dst)``
        or ``(src, dst, weight)`` arrays or triple iterables; ``deletes``
        takes ``(src, dst)`` pairs.  Returns the new graph epoch.  The
        session's degree arrays, its device out-degrees and the Bloom
        filters of the shards that changed are refreshed; the shared cache
        drops stale entries on next access.  Runs in flight pinned the
        previous epoch and raise ``ConcurrentMutationError`` rather than mix
        epochs (``GraphService.apply_mutations`` drains them first).
        """
        apply = getattr(self.store, "apply", None)
        if apply is None:
            raise TypeError(
                "this session's store is frozen; open it with "
                "GraphSession(path, mutable=True) (or wrap the store in a "
                "DeltaGraphStore) before applying edge mutations")
        epoch = apply(inserts=inserts, deletes=deletes, updates=updates)
        self._refresh_graph_state()
        return epoch

    def _refresh_graph_state(self) -> None:
        """Re-read graph-derived session state after the store's epoch
        moved, as ``VSWEngine._sync_graph_state`` does for an engine, so
        engines built after a commit start consistent.  ``n_pad`` only
        grows; the blooms list is shared by reference with every live
        engine and is updated in place."""
        prev = self._graph_epoch
        cur = _store_epoch(self.store)
        if cur == prev:
            return
        self.in_deg, self.out_deg = self.store.read_vertex_info()
        shard_meta = self.store.properties["shards"]
        self.max_rows = max((m["rows"] for m in shard_meta), default=8)
        self.n_pad = max(self.n_pad, self.n + self.max_rows)
        self.out_deg_dev = pad_to_device(self.out_deg, self.n_pad,
                                         self.device)
        shard_epoch = getattr(self.store, "shard_epoch", None)
        for p in range(self.store.num_shards):
            if shard_epoch is None or shard_epoch(p) > prev:
                self.blooms[p] = self.store.read_bloom(p)
        self._graph_epoch = cur

    def run_incremental(self, app: str | VertexProgram, *,
                        prev: RunResult, max_iters: int = 200,
                        config: EngineConfig | None = None,
                        **app_kwargs) -> RunResult:
        """Continue a previous run's fixpoint across graph mutations.

        ``prev`` must be the ``RunResult`` of the same application and
        source over this session's store.  When every commit since
        ``prev.epoch`` was monotone (insert-only / weight-non-increasing)
        and the application is registered ``incremental=True`` (SSSP, BFS,
        CC: min-propagations whose old fixpoint stays a valid upper bound),
        the run starts from ``prev``'s values with a frontier of just the
        source vertices the commits touched.

        Falls back to a cold run whenever that would be unsound: a
        non-incremental app, a delete or weight increase since
        ``prev.epoch``, an unconverged ``prev``, or an epoch log truncated
        past it.  If the store has not moved since ``prev``, returns the
        previous values (0 iterations).
        """
        program, prog_key = self._resolve(app, app_kwargs)
        if isinstance(program, (BatchedVertexProgram, DriverProgram)):
            raise TypeError(
                "run_incremental takes single-frontier applications; "
                "run_batch results cannot seed it")
        tag = VSWEngine._tag_for(program)
        if prev.tag is not None and prev.tag != tag:
            raise ValueError(
                f"prev result was produced by {prev.tag!r}, not {tag!r}; "
                "incremental recompute must continue the same program and "
                "source")
        cur = _store_epoch(self.store)
        if cur == prev.epoch and prev.converged:
            # nothing changed since prev: its fixpoint is still the answer
            return RunResult(values=np.array(prev.values), iterations=0,
                             history=[], converged=True, epoch=cur, tag=tag)
        name = app if isinstance(app, str) else program.name
        monotone_since = getattr(self.store, "monotone_since", None)
        seeds = None
        if (prev.converged and is_incremental(name)
                and monotone_since is not None
                and monotone_since(prev.epoch)):
            # None when the epoch log no longer reaches back to prev.epoch
            seeds = self.store.affected_sources_since(prev.epoch)
        eng = self._engine_for(program, prog_key, config)
        run_program = program if prog_key[0] == "sig" else None
        if seeds is None:
            return eng.run(max_iters=max_iters, program=run_program)
        active = np.zeros(self.n, dtype=bool)
        active[seeds] = True
        return eng.run(max_iters=max_iters, program=run_program,
                       init_state=(np.array(prev.values), active))

    # -- observability / lifecycle --------------------------------------
    @property
    def stats(self):
        """Shared edge-cache stats (hits, disk_bytes, ...); summed over the
        partitions of a multi-device session."""
        return self.cache.stats

    def cache_report(self) -> dict:
        """Snapshot of the shared edge cache (policy, mode, budget, tier
        occupancy, hit/miss/promotion/demotion/eviction counters,
        ``decode_seconds_saved``, achieved compression ratio); policy
        ``"partitioned"`` with one report per partition when
        ``num_devices > 1``."""
        return self.cache.report()

    def attach_hub(self, hub, prefix: str = "session"):
        """Wire this session's telemetry into a ``MetricsHub``
        (``repro_torch.obs``):

        * ``{prefix}.cache.*`` — a poller over ``cache_report()`` (numeric
          leaves flattened into gauges at each hub sample: tier occupancy,
          hit/miss/eviction counters, achieved compression ratio; the
          partitioned cache's per-partition sub-reports flatten too);
        * ``{prefix}.engine.*`` — an ``iteration_observers`` tap converting
          every ``IterationStats`` into counters (iterations, disk_bytes,
          edges_processed, stall/fetch/decode-saved seconds, per-lane
          ``engine.devN.*`` splits for multi-device runs), gauges (last
          active_ratio / cache_hit_ratio), and an
          ``{prefix}.engine.iteration_s`` histogram of sweep durations.

        Engines already built share the observer list by reference, so
        attaching mid-flight captures every subsequent iteration.  Returns
        ``hub`` for chaining.
        """
        hub.register_poller(f"{prefix}.cache", self.cache_report)
        iter_hist = hub.histogram(f"{prefix}.engine.iteration_s")
        eng = f"{prefix}.engine"

        def observe(stats) -> None:
            hub.counter(f"{eng}.iterations").inc()
            hub.counter(f"{eng}.disk_bytes").inc(stats.disk_bytes)
            hub.counter(f"{eng}.edges_processed").inc(stats.edges_processed)
            hub.counter(f"{eng}.shards_processed").inc(stats.shards_processed)
            hub.counter(f"{eng}.shards_skipped").inc(stats.shards_skipped)
            hub.counter(f"{eng}.stall_seconds").inc(stats.stall_seconds)
            hub.counter(f"{eng}.fetch_seconds").inc(stats.fetch_seconds)
            hub.counter(f"{eng}.decode_seconds_saved").inc(
                stats.decode_seconds_saved)
            hub.gauge(f"{eng}.active_ratio").set(stats.active_ratio)
            hub.gauge(f"{eng}.cache_hit_ratio").set(stats.cache_hit_ratio)
            iter_hist.observe(stats.seconds)
            for d, (db, ds, df) in enumerate(zip(stats.device_disk_bytes,
                                                 stats.device_stall_seconds,
                                                 stats.device_fetch_seconds)):
                hub.counter(f"{eng}.dev{d}.disk_bytes").inc(db)
                hub.counter(f"{eng}.dev{d}.stall_seconds").inc(ds)
                hub.counter(f"{eng}.dev{d}.fetch_seconds").inc(df)

        self.iteration_observers.append(observe)
        return hub

    def warm(self) -> int:
        """Pull every shard through the cache once; returns the bytes now
        resident."""
        for p in range(self.store.num_shards):
            self.cache.get(p)
        return self.cache.cached_bytes

    def close(self) -> None:
        """Drop engine and cache references, and close a store the session
        opened from a path (a packed store's mmap)."""
        self._engines.clear()
        self.cache.clear()
        if self._owns_store:
            getattr(self.store, "close", lambda: None)()

    def __enter__(self) -> "GraphSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"GraphSession({str(self.store.path)!r}, |V|={self.n}, "
                f"|E|={self.store.num_edges}, shards={self.store.num_shards}, "
                f"cache_mode={self.cache.mode}, device={self.device})")
