"""Graph applications as Init/Update vertex programs (paper Algorithm 3).

Each program is the vectorized form of the paper's per-vertex ``Init`` /
``Update`` pair, factored as (semiring, gather_transform, post, changed) —
see core/semiring.py.  ``init`` runs on the host in numpy; the other three
are torch functions on device tensors that the engine calls per shard.

Programs register themselves with ``@register_app`` so ``GraphSession.run``
(and anything else) can dispatch by name; downstream packages add workloads
the same way without touching this module.  This package carries the four
single-frontier applications of the paper (pagerank, sssp, bfs, cc), the
batched multi-source programs (sssp_multi, bfs_multi,
personalized_pagerank) and the serving metadata (``BatchSpec``,
``list_apps``) that ``GraphService`` reads; the rest of the reference's app
zoo is ROADMAP A7.
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
# the lp / kcore / triangle_count / random_walk specs come with their
# factories (ROADMAP A7)


# ---------------------------------------------------------------------------
# Registry introspection: what exists, how it dispatches, how it coalesces
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AppInfo:
    """One dispatchable application name and how it runs.

    ``kind`` is ``"vertex"`` (single-frontier ``session.run``),
    ``"batched"`` ([n, K] ``session.run_batch``) or ``"alias"`` (a
    serving-only name like ``"ppr"`` with no factory of its own — a K=1
    micro-batch of ``family`` is its solo form).  ``family`` is the
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
        kind = "batched" if isinstance(prog, BatchedVertexProgram) else "vertex"
        spec = _BATCH_SPECS.get(name)
        infos.append(AppInfo(name=name, kind=kind,
                             incremental=is_incremental(name),
                             family=spec.family if spec else None))
    for name, spec in _BATCH_SPECS.items():
        if name not in _REGISTRY:
            infos.append(AppInfo(name=name, kind="alias", incremental=False,
                                 family=spec.family))
    return tuple(sorted(infos, key=lambda i: i.name))
