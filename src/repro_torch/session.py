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

The store is a directory written by ``preprocess_graph`` (of this package
or the reference ``repro`` package: the format is shared) or any
constructed ``ShardSource``.
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.apps import (BatchedVertexProgram, VertexProgram,
                                   get_app)
from repro_torch.core.cache import CompressedShardCache, PartitionedShardCache
from repro_torch.core.distributed import ShardedVSWEngine, assign_shards
from repro_torch.core.engine import (BatchRunResult, EngineConfig,
                                     IterationStats, RunResult, VSWEngine,
                                     _store_epoch, pad_to_device)
from repro_torch.dist.context import make_data_devices
from repro_torch.graph.source import ShardSource
from repro_torch.graph.storage import GraphStore

BACKENDS = ("npz",)

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
# factories whose per-column parameter is not called "sources"; sources=
# still works and is rewritten onto the factory's own vocabulary
_BATCH_PARAMS = {"personalized_pagerank": "seeds"}
# batched factories and drivers of the reference's app zoo (ROADMAP A7)
_UNPORTED_BATCH_APPS = ("lp_multi", "kcore_multi", "triangles_multi",
                        "random_walks", "triangles")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to repro_torch yet "
                               f"(ROADMAP {item}); the repro package has it")


def _resolve_source(store, backend: str | None):
    """Turn (path, backend) into a ShardSource; pass storage objects through."""
    if not isinstance(store, (str, os.PathLike)):
        if backend is not None:
            raise TypeError(
                "backend= only applies when a graph path is given; got a "
                f"storage object ({type(store).__name__}) — pass its path, "
                "or drop backend=")
        return store
    if backend in ("packed", "memory"):
        raise _not_ported(f"backend={backend!r}", "A5b")
    if backend not in (None, "npz"):
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    store = GraphStore(store)
    store.properties  # validate up front: clear MissingGraphError, not a
    #                   raw ENOENT from vertex_info.npz deeper in __init__
    return store


class GraphSession:
    """Long-lived analytics session over one preprocessed graph.

    Parameters
    ----------
    store:
        A path to a preprocessed graph (npz directory) or any constructed
        ``ShardSource``.
    config:
        ``EngineConfig`` shared by every engine the session builds.  When
        omitted it comes from ``EngineConfig.from_env()``; extra keyword
        arguments (``cache_budget_bytes=...``, ``prefetch_depth=...``, ...)
        override single fields.
    max_engines:
        LRU bound on cached engines.
    backend:
        ``"npz"`` (the default).  ``"packed"``/``"memory"`` are ROADMAP A5b.
    mutable:
        Only ``False``: the delta store is ROADMAP A5b.
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
        if mutable:
            raise _not_ported("mutable=True (the delta store)", "A5b")
        store = _resolve_source(store, backend)
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
        if isinstance(app, (VertexProgram, BatchedVertexProgram)):
            if app_kwargs:
                raise TypeError(
                    "application kwargs only apply when dispatching by name; "
                    f"got a VertexProgram plus {sorted(app_kwargs)}")
            program = app
        else:
            program = get_app(app, **app_kwargs)
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
        return self._engine_for(program, prog_key, config)

    def _run_target(self, app, app_kwargs, config):
        """(engine, program-to-pin) for one run: signature-keyed engines get
        the resolved program pinned per call; name-keyed engines run their
        own program."""
        program, prog_key = self._resolve(app, app_kwargs)
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
        """
        eng, run_program = self._run_target(app, app_kwargs, config)
        return eng.run(max_iters=max_iters, checkpoint_dir=checkpoint_dir,
                       checkpoint_every=checkpoint_every, resume=resume,
                       program=run_program)

    def iter_run(self, app: str | VertexProgram, *, max_iters: int = 200,
                 checkpoint_dir: str | None = None, checkpoint_every: int = 0,
                 resume: bool = False, config: EngineConfig | None = None,
                 **app_kwargs) -> Iterator[IterationStats]:
        """Streaming form of ``run``: yields an ``IterationStats`` after
        every iteration; the ``RunResult`` is the generator's return value
        (``StopIteration.value``) and ``engine(app).last_result``."""
        eng, run_program = self._run_target(app, app_kwargs, config)
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
            given seeds), a batched factory name (``"sssp_multi"``/
            ``"bfs_multi"``/``"personalized_pagerank"``), or a
            ``BatchedVertexProgram``.
        sources:
            One frontier vertex per column (for PPR these are the ``seeds``;
            either spelling works).  Required when dispatching by name.
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
        if isinstance(app, BatchedVertexProgram):
            if sources is not None:
                raise TypeError(
                    "sources= only applies when dispatching by name; the "
                    "BatchedVertexProgram already fixes its frontiers")
            # forward app_kwargs so misuse raises like run() does
            program, prog_key = self._resolve(app, app_kwargs)
        else:
            name = _BATCH_ALIASES.get(app, app)
            if name in _UNPORTED_BATCH_APPS:
                raise _not_ported(f"run_batch({app!r})", "A7")
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

    # -- surfaces of the reference session not ported yet ---------------
    def run_incremental(self, *args, **kwargs):
        raise _not_ported("run_incremental", "A5b")

    def apply_mutations(self, *args, **kwargs):
        raise _not_ported("apply_mutations", "A5b")

    def attach_hub(self, *args, **kwargs):
        raise _not_ported("attach_hub (telemetry)", "A8")

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

    def warm(self) -> int:
        """Pull every shard through the cache once; returns the bytes now
        resident."""
        for p in range(self.store.num_shards):
            self.cache.get(p)
        return self.cache.cached_bytes

    def close(self) -> None:
        """Drop engine and cache references."""
        self._engines.clear()
        self.cache.clear()

    def __enter__(self) -> "GraphSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"GraphSession({str(self.store.path)!r}, |V|={self.n}, "
                f"|E|={self.store.num_edges}, shards={self.store.num_shards}, "
                f"cache_mode={self.cache.mode}, device={self.device})")
