"""Graph applications as Init/Update vertex programs (paper Algorithm 3).

Each program is the vectorized form of the paper's per-vertex ``Init`` /
``Update`` pair, factored as (semiring, gather_transform, post, changed) —
see core/semiring.py.  ``init`` runs on the host in numpy; the other three
are torch functions on device tensors that the engine calls per shard.

Programs register themselves with ``@register_app`` so ``GraphSession.run``
(and anything else) can dispatch by name; downstream packages add workloads
the same way without touching this module.  This package carries the
reference's whole registry: the paper's four applications (pagerank, sssp,
bfs, cc), the batched multi-source programs (sssp_multi, bfs_multi,
personalized_pagerank), the app zoo (label propagation, k-core, triangle
counting, random walks, with the host-driven ``triangles`` and
``random_walks``) and the serving metadata (``BatchSpec``, ``list_apps``)
that ``GraphService`` reads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor

# name -> factory(**kwargs) -> VertexProgram, read through get_app() /
# available_apps()
_REGISTRY: dict[str, Callable[..., "VertexProgram"]] = {}
# names whose fixpoints survive monotone graph growth (see is_incremental)
_INCREMENTAL: set[str] = set()


def register_app(name_or_factory=None, *, name: str | None = None,
                 incremental: bool = False):
    """Register a VertexProgram factory under a name.

    Usable bare (``@register_app``, name taken from the function) or with an
    explicit name (``@register_app("pr")``/``@register_app(name="pr")``).
    Re-registering a name overwrites it (latest wins), so tests can shadow.
    The factory's keyword arguments become the application's dispatch
    arguments (``GraphSession.run("sssp", source=3)``).

    ``incremental=True`` declares the app safe for incremental recompute
    after a *monotone* delta (insert-only / weight-non-increasing): its
    update is a min-propagation whose previous fixpoint stays a valid upper
    bound.  Apps whose values can move in either direction (PageRank) must
    leave it False.
    """
    if isinstance(name_or_factory, str):
        name = name_or_factory

    def deco(factory):
        final = name or factory.__name__
        _REGISTRY[final] = factory
        if incremental:
            _INCREMENTAL.add(final)
        else:
            _INCREMENTAL.discard(final)  # an overwrite drops the old claim
        return factory

    if callable(name_or_factory):
        return deco(name_or_factory)
    return deco


def is_incremental(name: str) -> bool:
    """True iff ``name`` was registered with ``incremental=True``."""
    return name in _INCREMENTAL


def get_app(name: str, **kwargs) -> "VertexProgram":
    """Instantiate a registered program; kwargs go to its factory."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown graph application {name!r}; "
            f"registered: {sorted(_REGISTRY)}") from None
    return factory(**kwargs)


def available_apps() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    name: str
    semiring: str
    value_dtype: np.dtype
    # (n, in_deg, out_deg) -> (values [n], active [n] bool)   (host-side, Algorithm 3 Init)
    init: Callable[[int, np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]]
    # (values, out_deg) -> x pulled along in-edges               (device)
    gather_transform: Callable[[Tensor, Tensor], Tensor]
    # (partial, old, num_vertices) -> new                         (device)
    post: Callable[[Tensor, Tensor, int], Tensor]
    # (new, old) -> bool mask of updated vertices                 (device)
    changed: Callable[[Tensor, Tensor], Tensor]
    needs_all_edges: bool = False  # True => every vertex recomputed each iter (PR)
    # frontier vertex ids this program was built for (() if source-free);
    # checkpoints record them so resume can reject a different run's state
    sources: tuple = ()
    # engine-sharing token: two programs with EQUAL jit_signature have
    # identical device callables (gather_transform / post / changed and
    # semiring), differing only in host-side init/sources, so one engine
    # serves both (e.g. every sssp source).  The name is kept from the
    # reference package, where it keys jitted steps; nothing is jitted here.
    # None => no sharing claim (engines keyed by program identity/name).
    # CONTRACT for dataclasses.replace(): overriding any device callable
    # MUST also replace jit_signature (or set it to None).  Renaming alone is
    # fine (bfs = sssp renamed shares sssp's engine deliberately).
    jit_signature: tuple | None = None


@register_app
def pagerank(damping: float = 0.85, tol: float = 1e-6) -> VertexProgram:
    """tol is RELATIVE (|Δ| > tol·|old|): the paper's Fig 7a shows PR active
    ratio under 0.1% by ~iteration 110 — absolute epsilons can't reproduce
    that across graph sizes, a relative one does."""
    def init(n, in_deg, out_deg):
        v = np.full(n, 1.0 / n, dtype=np.float32)
        return v, np.ones(n, dtype=bool)  # all vertices active (Alg 3 l.5)

    def gather(values, out_deg):
        return values / torch.clamp(out_deg, min=1).to(values.dtype)

    def post(partial, old, n):
        return (1.0 - damping) / n + damping * partial

    return VertexProgram(
        name="pagerank",
        semiring="plus_src",
        value_dtype=np.float32,
        init=init,
        gather_transform=gather,
        post=post,
        changed=lambda new, old: (new - old).abs() > tol * old.abs() + 1e-30,
        needs_all_edges=True,
        jit_signature=("pagerank", float(damping), float(tol)),
    )


_INF = np.float32(np.inf)


@register_app(incremental=True)
def sssp(source: int = 0) -> VertexProgram:
    def init(n, in_deg, out_deg):
        v = np.full(n, _INF, dtype=np.float32)
        v[source] = 0.0
        active = np.zeros(n, dtype=bool)
        active[source] = True  # only the source starts active (Alg 3 l.19)
        return v, active

    return VertexProgram(
        name="sssp",
        semiring="min_plus",
        value_dtype=np.float32,
        init=init,
        gather_transform=lambda values, out_deg: values,
        post=lambda partial, old, n: torch.minimum(partial, old),
        changed=lambda new, old: new < old,
        sources=(source,),
        # source only affects init: every SSSP/BFS query shares one engine
        jit_signature=("sssp",),
    )


@register_app(incremental=True)
def bfs(source: int = 0) -> VertexProgram:
    """Hop distance = SSSP with unit edge weights (vals are 1.0 in ELL)."""
    p = sssp(source)
    return dataclasses.replace(p, name="bfs")


@register_app(incremental=True)
def cc() -> VertexProgram:
    def init(n, in_deg, out_deg):
        v = np.arange(n, dtype=np.float32)  # subgraph id := vertex id (Alg 3 l.29)
        return v, np.ones(n, dtype=bool)

    return VertexProgram(
        name="cc",
        semiring="min_src",
        value_dtype=np.float32,
        init=init,
        gather_transform=lambda values, out_deg: values,
        post=lambda partial, old, n: torch.minimum(partial, old),
        changed=lambda new, old: new < old,
        jit_signature=("cc",),
    )


# ---------------------------------------------------------------------------
# Batched multi-source programs: one VSW sweep serves K frontiers
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BatchedVertexProgram:
    """K independent frontiers sharing one edge sweep (paper §2.2 economics,
    amortized across *queries* instead of applications).

    Values are [n, K] matrices; column k is exactly the single-source program
    for source k.  ``post`` additionally receives the *global* destination
    row ids of its slice, plus a slice of the optional ``make_aux`` matrix.

    ``make_aux`` carries per-column CONSTANTS (personalized PageRank's
    scaled seed one-hot) to ``post`` as a device [n, K] tensor the engine
    builds per run, so the program's device callables stay identical across
    source/seed sets: ``jit_signature`` need not include them, and a serving
    workload streaming distinct seed sets at the same K shares one engine.
    """

    name: str
    semiring: str
    value_dtype: np.dtype
    columns: int  # K
    # (n, in_deg, out_deg) -> (values [n, K], active [n, K] bool)   (host)
    init: Callable[[int, np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]]
    # (values [n_pad, K], out_deg [n_pad]) -> x pulled along in-edges
    gather_transform: Callable[[Tensor, Tensor], Tensor]
    # (partial [R, K], old [R, K], rows [R] global ids, num_vertices,
    #  aux [R, K] slice of make_aux(n) or None) -> new
    post: Callable[[Tensor, Tensor, Tensor, int, Tensor | None], Tensor]
    # (new [n, K], old [n, K]) -> bool mask of updated (vertex, column) pairs
    changed: Callable[[Tensor, Tensor], Tensor]
    # the K frontier vertex ids, column order; checkpoints record them so
    # resume rejects state from a different landmark/seed set
    sources: tuple = ()
    # engine-sharing token — see VertexProgram.jit_signature.  Batched
    # signatures include K but usually NOT the sources, so a serving layer
    # answering a stream of distinct landmark sets at the same K reuses one
    # engine.
    jit_signature: tuple | None = None
    # optional n -> [n, K] float32 constants delivered to post (sliced per
    # shard); None => post receives aux=None
    make_aux: Callable[[int], np.ndarray] | None = None
    # True => post takes a trailing iteration-number argument (a device
    # int32 scalar): post(partial, old, rows, n, aux, it)
    wants_iteration: bool = False


def _check_sources(sources) -> tuple[int, ...]:
    sources = tuple(int(s) for s in sources)
    if not sources:
        raise ValueError("need at least one source vertex")
    if any(s < 0 for s in sources):
        # negative ids would wrap under numpy indexing and silently compute
        # a plausible-looking column for vertex n+s
        raise ValueError(f"source vertex ids must be >= 0, got {sources}")
    return sources


@register_app
def sssp_multi(sources=(0,)) -> BatchedVertexProgram:
    """K single-source shortest-path queries in one engine run."""
    sources = _check_sources(sources)
    K = len(sources)

    def init(n, in_deg, out_deg):
        v = np.full((n, K), _INF, dtype=np.float32)
        active = np.zeros((n, K), dtype=bool)
        for k, s in enumerate(sources):
            v[s, k] = 0.0
            active[s, k] = True  # each column starts at its own source
        return v, active

    return BatchedVertexProgram(
        name="sssp_multi",
        semiring="min_plus",
        value_dtype=np.float32,
        columns=K,
        init=init,
        gather_transform=lambda values, out_deg: values,
        post=lambda partial, old, rows, n, aux: torch.minimum(partial, old),
        changed=lambda new, old: new < old,
        sources=sources,
        # only K shapes the [n, K] step: landmark sets share engines
        jit_signature=("sssp_multi", K),
    )


@register_app
def bfs_multi(sources=(0,)) -> BatchedVertexProgram:
    """K hop-distance queries (SSSP over unit edge weights)."""
    p = sssp_multi(sources)
    return dataclasses.replace(p, name="bfs_multi")


@register_app
def personalized_pagerank(seeds=(0,), damping: float = 0.85,
                          tol: float = 1e-6) -> BatchedVertexProgram:
    """K personalized-PageRank columns: pr_k = (1-d)·e_seed_k + d·Aᵀpr_k.

    The reset vector differs per column; it reaches ``post`` as the
    ``make_aux`` constant (the [n, K] scaled seed one-hot), so every seed
    set of the same K shares one engine.  Same relative-tol convergence
    rule as the global ``pagerank``.
    """
    seeds = _check_sources(seeds)
    K = len(seeds)
    seeds_np = np.asarray(seeds, dtype=np.int64)

    def init(n, in_deg, out_deg):
        v = np.zeros((n, K), dtype=np.float32)
        v[seeds_np, np.arange(K)] = 1.0  # all mass starts on the seed
        return v, np.ones((n, K), dtype=bool)

    def gather(values, out_deg):
        return values / torch.clamp(out_deg, min=1).to(values.dtype)[:, None]

    def make_aux(n):
        reset = np.zeros((n, K), dtype=np.float32)
        reset[seeds_np, np.arange(K)] = 1.0 - damping
        return reset

    return BatchedVertexProgram(
        name="personalized_pagerank",
        semiring="plus_src",
        value_dtype=np.float32,
        columns=K,
        init=init,
        gather_transform=gather,
        post=lambda partial, old, rows, n, aux: aux + damping * partial,
        changed=lambda new, old: (new - old).abs() > tol * old.abs() + 1e-30,
        sources=seeds,
        jit_signature=("personalized_pagerank", K, float(damping), float(tol)),
        make_aux=make_aux,
    )


# ---------------------------------------------------------------------------
# App zoo: label propagation, k-core, triangle counting, random walks
# ---------------------------------------------------------------------------
@register_app(incremental=True)
def label_propagation() -> VertexProgram:
    """Max-label broadcast: every vertex starts labeled with its own id and
    repeatedly adopts the largest label among itself and its in-neighbors
    (a dense-frontier max-propagation — the mirror image of ``cc``).  On a
    symmetric graph the fixpoint labels each component with its largest
    member.  Labels only grow, so the previous fixpoint stays a valid lower
    bound under insert-only deltas => ``incremental=True``."""
    def init(n, in_deg, out_deg):
        v = np.arange(n, dtype=np.float32)
        return v, np.ones(n, dtype=bool)

    return VertexProgram(
        name="label_propagation",
        semiring="max_src",
        value_dtype=np.float32,
        init=init,
        gather_transform=lambda values, out_deg: values,
        post=lambda partial, old, n: torch.maximum(partial, old),
        changed=lambda new, old: new > old,
        jit_signature=("label_propagation",),
    )


@register_app
def lp_multi(sources=(0,)) -> BatchedVertexProgram:
    """K seeded label broadcasts in one sweep: column k starts with label
    ``source_k`` on its seed and -1 ("unreached") everywhere else, so the
    fixpoint marks exactly the vertices the seed's label can reach (along
    in-edges; reachability from the seed on symmetric graphs).  -1 stays
    below every real label AND above the segment-fold identity (-inf), so
    unreached rows stay at -1."""
    sources = _check_sources(sources)
    K = len(sources)

    def init(n, in_deg, out_deg):
        v = np.full((n, K), -1.0, dtype=np.float32)
        active = np.zeros((n, K), dtype=bool)
        for k, s in enumerate(sources):
            v[s, k] = float(s)
            active[s, k] = True
        return v, active

    return BatchedVertexProgram(
        name="lp_multi",
        semiring="max_src",
        value_dtype=np.float32,
        columns=K,
        init=init,
        gather_transform=lambda values, out_deg: values,
        post=lambda partial, old, rows, n, aux: torch.maximum(partial, old),
        changed=lambda new, old: new > old,
        sources=sources,
        jit_signature=("lp_multi", K),
    )


def _check_thresholds(ks) -> tuple[int, ...]:
    ks = tuple(int(k) for k in ks)
    if not ks:
        raise ValueError("need at least one k threshold")
    if any(k < 0 for k in ks):
        raise ValueError(f"k-core thresholds must be >= 0, got {ks}")
    return ks


@register_app
def kcore(k: int = 2) -> VertexProgram:
    """k-core decomposition membership: iterated peeling of vertices with
    fewer than k live in-neighbors (degree, on symmetric graphs).

    values are alive flags in {0, 1}; each sweep pulls the live-neighbor
    count through plus_src and kills vertices below the threshold, which
    converges to the largest set where every member keeps >= k live
    neighbors — the k-core.  Deletions are absorbing (changed = new < old),
    so the frontier is the vertices that just died.  NOT incremental: edge
    inserts can resurrect a peeled vertex, which a frontier seeded from the
    old fixpoint never does — ``run_incremental`` falls back to a cold
    run."""
    k = int(k)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")

    def init(n, in_deg, out_deg):
        return np.ones(n, dtype=np.float32), np.ones(n, dtype=bool)

    def post(partial, old, n):
        return torch.where((old > 0) & (partial >= k), 1.0, 0.0).to(old.dtype)

    return VertexProgram(
        name="kcore",
        semiring="plus_src",
        value_dtype=np.float32,
        init=init,
        gather_transform=lambda values, out_deg: values,
        post=post,
        changed=lambda new, old: new < old,
        jit_signature=("kcore", k),
    )


@register_app
def kcore_multi(ks=(2,)) -> BatchedVertexProgram:
    """K simultaneous k-core peels, one threshold per column.  The
    thresholds reach ``post`` through ``make_aux`` as a device [n, K]
    constant, so every threshold set of the same K shares one engine."""
    ks = _check_thresholds(ks)
    K = len(ks)
    ks_np = np.asarray(ks, dtype=np.float32)

    def init(n, in_deg, out_deg):
        return (np.ones((n, K), dtype=np.float32),
                np.ones((n, K), dtype=bool))

    def make_aux(n):
        return np.broadcast_to(ks_np, (n, K)).copy()

    def post(partial, old, rows, n, aux):
        return torch.where((old > 0) & (partial >= aux), 1.0, 0.0).to(
            old.dtype)

    return BatchedVertexProgram(
        name="kcore_multi",
        semiring="plus_src",
        value_dtype=np.float32,
        columns=K,
        init=init,
        gather_transform=lambda values, out_deg: values,
        post=post,
        changed=lambda new, old: new < old,
        sources=ks,
        jit_signature=("kcore_multi", K),
        make_aux=make_aux,
    )


@register_app
def triangles_multi(vertices=(0,)) -> BatchedVertexProgram:
    """Per-vertex triangle counts for K probe vertices via two pull passes.

    Column k probes vertex u = vertices[k]:

      pass 0 (it == 0): from the one-hot e_u, partial[v] counts edges
        u -> v; clamping to {0, 1} leaves Z[v] = A[u, v], the in-neighbor
        indicator of u.
      pass 1 (it == 1): partial[v] = sum_w A[w, v] * Z[w] counts common
        neighbors of u and v; new[v] = Z[v] * partial[v] keeps it only on
        v in N(u).  On a symmetric simple graph, sum_v new[v] counts each
        triangle through u twice, so t(u) = sum(values[:, k]) / 2.

    ``wants_iteration`` keys the update on the sweep number, a device int32
    scalar broadcast by ``torch.where`` (no host sync); from it >= 2 the
    post is the identity, so the run converges on its third sweep under any
    ``max_iters``.  Pass 0 starts all-active (the probe must reach every
    shard); pass 1's frontier is whatever pass 0 changed."""
    vertices = _check_sources(vertices)
    K = len(vertices)
    verts_np = np.asarray(vertices, dtype=np.int64)

    def init(n, in_deg, out_deg):
        v = np.zeros((n, K), dtype=np.float32)
        v[verts_np, np.arange(K)] = 1.0
        return v, np.ones((n, K), dtype=bool)

    def post(partial, old, rows, n, aux, it):
        probe = (partial > 0).to(old.dtype)   # pass 0: Z = A[u, :]
        closed = old * partial                # pass 1: Z ∘ (A^T Z)
        return torch.where(it == 0, probe,
                           torch.where(it == 1, closed, old))

    return BatchedVertexProgram(
        name="triangles_multi",
        semiring="plus_src",
        value_dtype=np.float32,
        columns=K,
        init=init,
        gather_transform=lambda values, out_deg: values,
        post=post,
        changed=lambda new, old: new != old,
        sources=vertices,
        jit_signature=("triangles_multi", K),
        wants_iteration=True,
    )


# ---------------------------------------------------------------------------
# Host-driven applications: the program orchestrates the session itself
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DriverProgram:
    """An application whose outer loop runs on the HOST instead of inside
    the engine's sweep: ``run(session, max_iters=..., config=...)``
    orchestrates engine runs (triangle counting's chunked probe sweep) or
    walks the shard cache directly (random-walk sampling), and returns a
    ``RunResult``/``BatchRunResult`` like any vertex program.  Dispatched by
    ``GraphSession.run`` / ``run_batch`` through the same registry; engine
    checkpoints/resume do not apply (drivers reject those arguments)."""

    name: str
    # (session, *, max_iters, config) -> RunResult | BatchRunResult
    run: Callable
    batched: bool = False  # True => run returns a BatchRunResult
    sources: tuple = ()


@register_app
def triangles(chunk: int = 64, lo: int = 0,
              hi: int | None = None) -> DriverProgram:
    """Per-vertex triangle counts for EVERY vertex: drives
    ``triangles_multi`` over probe-vertex chunks of a fixed width (constant
    K keeps all chunks on one engine; the last chunk pads by repeating its
    final vertex and drops the duplicate columns).  Returns a ``RunResult``
    whose values[v] is the number of triangles through v on a symmetric
    simple graph; ``sum(values) / 3`` is the global count.

    ``lo``/``hi`` restrict the probe vertices to the slab ``[lo, hi)``
    (default: all of them) — counts outside the slab stay zero.  Each
    chunk still streams every shard, so a slab run exercises the full I/O
    path at a fraction of the sweep count."""
    chunk = int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    def run(session, *, max_iters: int = 200, config=None):
        from repro_torch.core.engine import RunResult
        n = session.n
        stop = n if hi is None else min(int(hi), n)
        start = max(int(lo), 0)
        if start >= stop:
            raise ValueError(
                f"empty triangle slab [{lo}, {hi}) on {n} vertices")
        C = min(chunk, stop - start)
        counts = np.zeros(n, dtype=np.float32)
        history, iterations, epoch = [], 0, 0
        for lo_c in range(start, stop, C):
            vs = list(range(lo_c, min(lo_c + C, stop)))
            take = len(vs)
            vs += [vs[-1]] * (C - take)  # pad: constant K => one engine
            session.run_batch("triangles_multi", vertices=vs,
                              max_iters=max_iters, config=config)
            batch = session.last_batch_result
            vals = np.asarray(batch.values)
            counts[lo_c:lo_c + take] = 0.5 * vals[:, :take].sum(axis=0)
            history.extend(batch.history)
            iterations += batch.iterations
            epoch = batch.epoch
        return RunResult(values=counts, iterations=iterations,
                         history=history, converged=True, epoch=epoch,
                         tag=f"triangles:({start},{stop})")

    return DriverProgram(name="triangles", run=run)


@register_app
def random_walks(sources=(0,), length: int = 8,
                 seed: int = 0) -> DriverProgram:
    """K batched random walks, one per source, as [n, K] visit counts.

    Walks step along the pull layout's native adjacency — the IN-edges
    held by each destination interval's shard (on symmetric graphs, the
    standard uniform random walk).  Each step looks the current vertex's
    shard up through the session's shared compressed cache (``cache.get``
    — the walk IS the cache workload) and picks among its neighbors in
    canonical ELL order.  The walk runs on the host over the cache's numpy
    shards and never touches the session's device.

    The per-step choice uses numpy's counter-based Philox stream keyed by
    (seed, source) with the step index as the counter block, so every
    column is a pure function of its own (seed, source) — batched walks
    are bitwise identical to solo walks regardless of batch composition,
    and to the reference package's walks.  A walk halts at a dead end
    (vertex with no in-edges).  Visit counts include the starting
    position; ``column_iterations[k]`` is the number of steps walk k
    actually took."""
    sources = _check_sources(sources)
    length = int(length)
    seed = int(seed)
    if length < 0:
        raise ValueError(f"length must be >= 0, got {length}")
    K = len(sources)

    def run(session, *, max_iters: int = 200, config=None):
        import time

        from repro_torch.core.engine import (BatchRunResult, IterationStats,
                                             _store_epoch)
        n = session.n
        intervals = np.asarray(session.store.intervals, dtype=np.int64)
        counts = np.zeros((n, K), dtype=np.float32)
        cur = np.asarray(sources, dtype=np.int64)
        alive = np.ones(K, dtype=bool)
        counts[cur, np.arange(K)] += 1.0  # position 0
        col_iters = np.zeros(K, dtype=np.int64)
        history = []
        steps = min(length, int(max_iters))
        epoch = _store_epoch(session.store)
        for step in range(steps):
            if not alive.any():
                break
            t0 = time.perf_counter()
            s0 = session.cache.stats
            disk0, hits0, miss0 = s0.disk_bytes, s0.hits, s0.misses
            edges = 0
            for k in range(K):  # fixed order => deterministic cache trace
                if not alive[k]:
                    continue
                v = int(cur[k])
                p = int(np.searchsorted(intervals, v, side="right")) - 1
                shard = session.cache.get(p)
                rows = np.nonzero(shard.row_map == v - shard.start_vertex)[0]
                nbrs = shard.cols[rows].ravel()
                nbrs = nbrs[nbrs >= 0]  # canonical ELL order
                edges += int(nbrs.size)
                if nbrs.size == 0:
                    alive[k] = False  # dead end: the walk halts
                    continue
                # counter-based stream: f(seed, source, step) — column k's
                # draws never depend on the other columns
                bits = np.random.Philox(
                    key=np.array([seed, sources[k]], dtype=np.uint64),
                    counter=np.array([step, 0, 0, 0], dtype=np.uint64))
                idx = np.random.Generator(bits).integers(nbrs.size)
                cur[k] = int(nbrs[idx])
                counts[cur[k], k] += 1.0
                col_iters[k] += 1
            s1 = session.cache.stats
            dh, dm = s1.hits - hits0, s1.misses - miss0
            history.append(IterationStats(
                iteration=step, seconds=time.perf_counter() - t0,
                active_ratio=float(alive.mean()),
                shards_processed=dh + dm, shards_skipped=0,
                disk_bytes=s1.disk_bytes - disk0,
                cache_hit_ratio=dh / max(dh + dm, 1),
                selective_enabled=False, edges_processed=edges))
        return BatchRunResult(
            values=counts, iterations=len(history), history=history,
            converged=True, epoch=epoch,
            tag=f"random_walks:{tuple(sources)}",
            column_iterations=col_iters,
            column_converged=np.ones(K, dtype=bool))

    return DriverProgram(name="random_walks", run=run, batched=True,
                         sources=sources)


# ---------------------------------------------------------------------------
# Batch-compatibility metadata: which single-query apps coalesce, and how
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BatchSpec:
    """How K independent single-source queries of one app become one
    ``run_batch`` call.  The serving layer
    (``repro_torch/serve/graph_service.py``) coalesces pending requests whose
    ``BatchSpec`` AND non-source parameters agree into one [n, K]
    micro-batch; ``family`` names the compatibility class (same batched
    factory + same semiring => same sweep can serve them)."""

    family: str        # compatibility class, e.g. "min_plus/sssp_multi"
    batched_app: str   # registered factory answering K queries at once
    source_param: str  # the single-query frontier kwarg ("source" / "seed")
    batch_param: str   # the batched factory's K-tuple kwarg ("sources"/"seeds")
    semiring: str      # shared semiring (informational; part of the family)
    exact: bool = True  # column k bitwise-equals the solo run (min-propagation
    #                     semirings; False for float-accumulating ones)


_BATCH_SPECS: dict[str, BatchSpec] = {}


def register_batchable(name: str, spec: BatchSpec) -> None:
    """Declare that single-query app ``name`` coalesces per ``spec``."""
    _BATCH_SPECS[name] = spec


def batch_spec(name: str) -> BatchSpec | None:
    """The BatchSpec for a single-query app name (None = not batchable)."""
    return _BATCH_SPECS.get(name)


register_batchable("sssp", BatchSpec(
    family="min_plus/sssp_multi", batched_app="sssp_multi",
    source_param="source", batch_param="sources", semiring="min_plus"))
register_batchable("bfs", BatchSpec(
    family="min_plus/bfs_multi", batched_app="bfs_multi",
    source_param="source", batch_param="sources", semiring="min_plus"))
# "ppr" has no solo VertexProgram (the seed reset needs the batched post's
# aux) — a K=1 micro-batch IS its solo form.  plus_src accumulates floats,
# so coalesced columns match solo K=1 runs to tolerance, not bitwise.
register_batchable("ppr", BatchSpec(
    family="plus_src/personalized_pagerank", batched_app="personalized_pagerank",
    source_param="seed", batch_param="seeds", semiring="plus_src", exact=False))
# "lp" (seeded label broadcast from one source) has no solo VertexProgram —
# like "ppr", a K=1 micro-batch IS its solo form.  max_src propagates exact
# integral labels, so coalesced columns match solo runs bitwise.
register_batchable("lp", BatchSpec(
    family="max_src/lp_multi", batched_app="lp_multi",
    source_param="source", batch_param="sources", semiring="max_src"))
# "kcore" coalesces by THRESHOLD, not frontier: K peels with different k
# share one sweep, the thresholds riding in as the make_aux constant.
register_batchable("kcore", BatchSpec(
    family="plus_src/kcore_multi", batched_app="kcore_multi",
    source_param="k", batch_param="ks", semiring="plus_src"))
register_batchable("triangle_count", BatchSpec(
    family="plus_src/triangles_multi", batched_app="triangles_multi",
    source_param="vertex", batch_param="vertices", semiring="plus_src"))
register_batchable("random_walk", BatchSpec(
    family="walk/random_walks", batched_app="random_walks",
    source_param="source", batch_param="sources", semiring="walk"))


# ---------------------------------------------------------------------------
# Registry introspection: what exists, how it dispatches, how it coalesces
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AppInfo:
    """One dispatchable application name and how it runs.

    ``kind`` is ``"vertex"`` (single-frontier ``session.run``),
    ``"batched"`` ([n, K] ``session.run_batch``), ``"driver"``
    (host-orchestrated) or ``"alias"`` (a serving-only name like ``"ppr"``
    with no factory of its own — a K=1 micro-batch of ``family`` is its
    solo form).  ``family`` is the
    BatchSpec compatibility class when the name coalesces in the serving
    layer, else None."""

    name: str
    kind: str
    incremental: bool
    family: str | None


def list_apps() -> tuple[AppInfo, ...]:
    """Every dispatchable application name, sorted, with its dispatch kind
    and serving metadata — so the serving layer and tests can enumerate the
    registry instead of hard-coding names.  Factories are probed with their
    default arguments to classify the returned program."""
    infos = []
    for name in available_apps():
        try:
            prog = _REGISTRY[name]()
        except Exception:  # a factory without defaults stays dispatchable
            prog = None
        if isinstance(prog, DriverProgram):
            kind = "driver"
        elif isinstance(prog, BatchedVertexProgram):
            kind = "batched"
        else:
            kind = "vertex"
        spec = _BATCH_SPECS.get(name)
        infos.append(AppInfo(name=name, kind=kind,
                             incremental=is_incremental(name),
                             family=spec.family if spec else None))
    for name, spec in _BATCH_SPECS.items():
        if name not in _REGISTRY:
            infos.append(AppInfo(name=name, kind="alias", incremental=False,
                                 family=spec.family))
    return tuple(sorted(infos, key=lambda i: i.name))


# Deprecated alias: the live registry itself (mutations via register_app
# are visible here and vice versa).  Prefer get_app()/register_app.
APPS = _REGISTRY
