"""Graph applications as Init/Update vertex programs (paper Algorithm 3).

Each program is the vectorized form of the paper's per-vertex ``Init`` /
``Update`` pair, factored as (semiring, gather_transform, post, changed) —
see core/semiring.py.  ``init`` runs on the host in numpy; the other three
are torch functions on device tensors that the engine calls per shard.

Programs register themselves with ``@register_app`` so ``GraphSession.run``
(and anything else) can dispatch by name; downstream packages add workloads
the same way without touching this module.  This package carries the four
single-frontier applications of the paper (pagerank, sssp, bfs, cc); the
batched programs and the rest of the reference's app zoo are ROADMAP A6/A7.
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
