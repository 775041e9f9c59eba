"""Lane-by-lane SPMD: the port's counterpart of ``jax.shard_map`` and of
the ``jax.lax`` collectives, over a ``dist.context.Mesh`` in one process.

A value split over a mesh is a numpy object array of the mesh's shape
holding one tensor per lane (``shard``); ``lanewise`` runs a function on
each lane's tensors, and the collectives move tensors between lanes
explicitly (``.to(lane)``, ``torch.cat``, sums), so autograd trains
through them with no custom backward: the transpose of ``all_gather`` is
``psum_scatter`` and the other way round, as jax's.  Lanes on one device
move nothing: ``shard`` hands out views, ``.to`` to the same device is the
tensor itself, and the lanes of a group that share a device share one
gathered tensor.  ``Lanes`` is a global array held as one tensor a lane
(the KV caches and the optimizer state of a mesh model).

``representative_lane()``: inside it, ``lanewise`` runs ``fn`` on the
first lane only and hands its result to every lane, and each collective
computes its first group's result for all.  An SPMD program's lanes run
the same ops on the same shapes, so this is one lane's program, as the
reference's SPMD partitioner compiles one program for every device: the
dry run traces ``meta`` meshes of 256 lanes this way, and its counts are
one lane's.

Every collective computes its result once per group of lanes, in the
order of the lanes' index along the reduced axes, and hands that result to
each lane of the group: every lane holds the same value, as an all-reduce
gives.

``count_collectives()`` records, while it is active, each collective's
per-lane result bytes by the kind names of XLA's HLO (``psum`` and
``pmax`` are an ``all-reduce``, ``pmean`` its ``psum`` once,
``all_to_all`` an ``all-to-all``, ``all_gather`` an ``all-gather`` and
``psum_scatter`` a ``reduce-scatter``), and the bytes of each one's
transpose when autograd runs it backward (the gradient of a lane's
result under the same kind; a gather's transpose is a ``reduce-scatter``
of the lane's shard, a reduce-scatter's an ``all-gather``).  A collective
called with a ``label`` adds its bytes to its kind and also under
``counts.labelled["<kind>: <label>"]``, so a caller can name a part of a
kind.
Inactive, it costs one test a call.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.dist.context import Mesh, PartitionSpec


class Counts(dict):
    """{kind: per-lane result bytes}, and ``labelled``: {"kind: label":
    bytes} of the labelled collectives (also in their kind's total)."""

    def __init__(self):
        super().__init__()
        self.labelled: dict[str, int] = {}

    def add(self, kind: str, n: int, label: str | None) -> None:
        self[kind] = self.get(kind, 0) + int(n)
        if label is not None:
            key = f"{kind}: {label}"
            self.labelled[key] = self.labelled.get(key, 0) + int(n)


# the active counter of this thread or task, if any
_counts: contextvars.ContextVar[Counts | None] = \
    contextvars.ContextVar("collective_counts", default=None)
# whether lanewise and the collectives run the first lane for all
_one_lane: contextvars.ContextVar[bool] = \
    contextvars.ContextVar("representative_lane", default=False)


@contextlib.contextmanager
def count_collectives():
    """-> a ``Counts`` dict {kind: per-lane result bytes} that the
    collectives run inside the block (and their backward passes) add to.
    A lane's bytes are those of lane 0's result: every lane of a mesh
    joins each collective with a result of the same shape."""
    counts = Counts()
    token = _counts.set(counts)
    try:
        yield counts
    finally:
        _counts.reset(token)


@contextlib.contextmanager
def representative_lane():
    """Run one lane's program for every lane (module docstring)."""
    token = _one_lane.set(True)
    try:
        yield
    finally:
        _one_lane.reset(token)


def representative() -> bool:
    """Whether ``representative_lane`` is active."""
    return _one_lane.get()


# set while ``unshard`` assembles a whole value under
# ``representative_lane``: an op there is no lane's (the dry run skips it)
assembling: contextvars.ContextVar[bool] = \
    contextvars.ContextVar("assembling", default=False)


def _record(kind: str, out: np.ndarray, *, back: str | None = None,
            back_scale: tuple[int, int] = (1, 1),
            label: str | None = None) -> np.ndarray:
    """Count lane 0's result bytes of ``out`` under ``kind``, and when
    autograd runs it backward, its gradient's bytes times ``back_scale``
    (num, den) under ``back`` (default: ``kind``)."""
    counts = _counts.get()
    if counts is None:
        return out
    lane = out.flat[0]
    counts.add(kind, lane.numel() * lane.element_size(), label)
    if lane.requires_grad:
        num, den = back_scale

        def backward(grad):
            counts.add(back or kind,
                       grad.numel() * grad.element_size() * num // den,
                       label)
        lane.register_hook(backward)
    return out


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def _linear(pos: dict[str, int], mesh: Mesh, axes: tuple[str, ...]) -> int:
    """A lane's index along ``axes`` taken together (the first major)."""
    k = 0
    for a in axes:
        k = k * mesh.shape[a] + pos[a]
    return k


def _lanes(mesh: Mesh):
    """(mesh index, {axis: position}) of every lane, in row-major order."""
    for idx in np.ndindex(mesh.devices.shape):
        yield idx, dict(zip(mesh.axis_names, idx))


def axis_index(mesh: Mesh, axes) -> np.ndarray:
    """Each lane's index along ``axes`` (a name or a tuple of names), as
    ``jax.lax.axis_index``: an int array of the mesh's shape."""
    axes = _axes(axes)
    out = np.zeros(mesh.devices.shape, dtype=np.int64)
    for idx, pos in _lanes(mesh):
        out[idx] = _linear(pos, mesh, axes)
    return out


def shard(x: torch.Tensor, spec: PartitionSpec, mesh: Mesh) -> np.ndarray:
    """Split ``x`` by ``spec`` into per-lane tensors, each on its lane's
    device (a view where the lane shares ``x``'s device).  A dim split
    over axes of total size n must be divisible by n."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than x has dims "
                         f"({tuple(x.shape)})")
    out = np.empty(mesh.devices.shape, dtype=object)
    for idx, pos in _lanes(mesh):
        part = x
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            if not axes:
                continue
            n = math.prod(mesh.shape[a] for a in axes)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split over {axes} ({n} lanes)")
            size = x.shape[dim] // n
            part = part.narrow(dim, _linear(pos, mesh, axes) * size, size)
        out[idx] = part.to(mesh.devices[idx])
    return out


def unshard(parts: np.ndarray, spec: PartitionSpec, mesh: Mesh,
            device: torch.device | None = None) -> torch.Tensor:
    """The inverse of ``shard``: the whole tensor, on ``device`` (default:
    the mesh's first lane), from the lanes at position 0 of every axis
    ``spec`` does not split over."""
    if _one_lane.get() and not assembling.get():
        token = assembling.set(True)
        try:
            return unshard(parts, spec, mesh, device)
        finally:
            assembling.reset(token)
    dev = mesh.first_device if device is None else device
    used = {a for entry in spec for a in _axes(entry)}
    blocks = {}
    for idx, pos in _lanes(mesh):
        if any(pos[a] for a in mesh.axis_names if a not in used):
            continue
        key = tuple(_linear(pos, mesh, _axes(entry)) for entry in spec)
        blocks[key] = parts[idx].to(dev)

    def assemble(prefix: tuple, dim: int) -> torch.Tensor:
        if dim == len(spec):
            return blocks[prefix]
        n = math.prod(mesh.shape[a] for a in _axes(spec[dim]))
        pieces = [assemble(prefix + (k,), dim + 1) for k in range(n)]
        return pieces[0] if n == 1 else torch.cat(pieces, dim)
    return assemble((), 0)


class Lanes:
    """A global array held as one tensor a lane: ``parts`` (an object
    array of the mesh's shape) split by ``spec``.  ``shape`` and
    ``dtype`` are the global array's, as jax's ``jax.Array``; ``full``
    assembles it (``unshard``)."""

    __slots__ = ("parts", "spec", "mesh", "shape", "dtype")

    def __init__(self, parts: np.ndarray, spec: PartitionSpec, mesh: Mesh,
                 shape, dtype: torch.dtype):
        self.parts, self.spec, self.mesh = parts, PartitionSpec(*spec), mesh
        self.shape, self.dtype = torch.Size(shape), dtype

    @classmethod
    def split(cls, x: torch.Tensor, spec: PartitionSpec,
              mesh: Mesh) -> "Lanes":
        """``x`` split by ``spec``, each lane's part a copy of its own."""
        return cls(own(shard(x, spec, mesh)), spec, mesh, x.shape, x.dtype)

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def device(self) -> torch.device:
        return self.parts.flat[0].device

    def full(self, device: torch.device | None = None) -> torch.Tensor:
        return unshard(self.parts, self.spec, self.mesh, device)

    def __repr__(self) -> str:
        return (f"Lanes({tuple(self.shape)}, {self.dtype}, {self.spec}, "
                f"{self.mesh})")


def lane_indices(shape):
    """The lanes of a lanes array of ``shape`` a loop visits: every one,
    or the first under ``representative_lane``."""
    for idx in np.ndindex(shape):
        yield idx
        if _one_lane.get():
            return


def own(parts: np.ndarray, dtype: torch.dtype | None = None) -> np.ndarray:
    """Each lane's tensor copied into storage of its own, of exactly its
    size (no view of a tensor another lane holds), cast to ``dtype`` on
    the way when given."""
    out = np.empty(parts.shape, dtype=object)
    for idx in np.ndindex(parts.shape):
        t = parts[idx]
        out[idx] = torch.empty(t.shape, dtype=dtype or t.dtype,
                               device=t.device).copy_(t)
    return out


def lanewise(fn: Callable, *args):
    """``fn`` on each lane: every argument that is a lanes array gives
    its lane's entry, any other is passed as it is.  -> a lanes array, or
    a tuple of them when ``fn`` returns a tuple."""
    shape = next(a.shape for a in args if isinstance(a, np.ndarray))
    results = {}
    for idx in np.ndindex(shape):
        results[idx] = fn(*(a[idx] if isinstance(a, np.ndarray) else a
                            for a in args))
        if _one_lane.get():
            break
    first = next(iter(results.values()))
    n = len(first) if isinstance(first, tuple) else None
    outs = [np.empty(shape, dtype=object) for _ in range(n or 1)]
    for idx in np.ndindex(shape):
        res = results.get(idx, first)
        for k, out in enumerate(outs):
            out[idx] = res[k] if n is not None else res
    return tuple(outs) if n is not None else outs[0]


def _groups(mesh: Mesh, axes: tuple[str, ...]) -> list[list[tuple]]:
    """The lanes that a collective over ``axes`` joins: one list per
    position on the other axes, ordered by the index along ``axes``."""
    groups: dict[tuple, list] = {}
    for idx, pos in _lanes(mesh):
        rest = tuple(pos[a] for a in mesh.axis_names if a not in axes)
        groups.setdefault(rest, []).append((_linear(pos, mesh, axes), idx))
    return [[idx for _, idx in sorted(g)] for g in groups.values()]


def _collect(parts: np.ndarray, axes, mesh: Mesh, make) -> np.ndarray:
    """``make(group, k, dst)`` for lane ``dst``, the ``k``-th of its group
    along ``axes``; the lanes of a group on one device share the result
    of the first of them when ``make`` gives every lane the same value
    (``k`` is None then).  Under ``representative_lane`` the first
    group's first lane's result goes to every lane."""
    axes = _axes(axes)
    out = np.empty(parts.shape, dtype=object)
    one = _one_lane.get()
    for group in _groups(mesh, axes):
        made: dict = {}
        for k, dst in enumerate(group):
            out[dst] = make(group, k, dst, made)
            if one:
                for idx in np.ndindex(out.shape):
                    out[idx] = out[dst]
                return out
    return out


def _reduce(parts: np.ndarray, axes, mesh: Mesh, op) -> np.ndarray:
    def make(group, k, dst, made):
        if "total" not in made:
            home = mesh.devices[group[0]]
            total = parts[group[0]]
            for idx in group[1:]:
                total = op(total, parts[idx].to(home))
            made["total"] = total
        return made["total"].to(mesh.devices[dst])
    return _collect(parts, axes, mesh, make)


def psum(parts: np.ndarray, axes, mesh: Mesh) -> np.ndarray:
    """``jax.lax.psum`` over one mesh axis or a tuple of them."""
    return _record("all-reduce", _reduce(parts, axes, mesh, torch.add))


def pmax(parts: np.ndarray, axes, mesh: Mesh) -> np.ndarray:
    """``jax.lax.pmax``: the elementwise maximum over the axes."""
    return _record("all-reduce", _reduce(parts, axes, mesh, torch.maximum))


def pmean(parts: np.ndarray, axes, mesh: Mesh) -> np.ndarray:
    """``jax.lax.pmean``: ``psum`` divided by the number of lanes joined."""
    n = math.prod(mesh.shape[a] for a in _axes(axes))
    return lanewise(lambda t: t / n, psum(parts, axes, mesh))


def all_to_all(parts: np.ndarray, axis: str, split_axis: int,
               concat_axis: int, mesh: Mesh, *,
               label: str | None = None) -> np.ndarray:
    """``jax.lax.all_to_all(..., tiled=True)`` over one mesh axis of n
    lanes: each lane cuts its tensor into n chunks along ``split_axis``,
    chunk k goes to lane k, and each lane concatenates what it receives
    along ``concat_axis`` in the senders' index order.  Its backward is
    the inverse all-to-all."""
    n = mesh.shape[axis]
    size = parts.flat[0].shape[split_axis]
    if size % n:
        raise ValueError(f"all_to_all: dim {split_axis} of size {size} "
                         f"does not split into {n} chunks")
    size //= n

    def make(group, k, dst, made):
        dev = mesh.devices[dst]
        return torch.cat([parts[src].narrow(split_axis, k * size, size)
                          .to(dev) for src in group], concat_axis)
    return _record("all-to-all", _collect(parts, (axis,), mesh, make),
                   label=label)


def all_gather(parts: np.ndarray, axes, dim: int, mesh: Mesh, *,
               label: str | None = None) -> np.ndarray:
    """``jax.lax.all_gather(..., tiled=True)`` over ``axes`` (a name or a
    tuple, the first major): every lane of a group gets its lanes' parts
    concatenated along ``dim`` in their index order.  Its backward, a
    ``psum_scatter``, is counted as a ``reduce-scatter`` of the lane's
    shard."""
    n = math.prod(mesh.shape[a] for a in _axes(axes))
    if n == 1:  # a group of one lane: nothing moves
        return parts

    def make(group, k, dst, made):
        dev = mesh.devices[dst]
        if dev not in made:
            made[dev] = torch.cat([parts[src].to(dev) for src in group], dim)
        return made[dev]
    return _record("all-gather", _collect(parts, axes, mesh, make),
                   back="reduce-scatter", back_scale=(1, n), label=label)


def psum_scatter(parts: np.ndarray, axes, dim: int, mesh: Mesh, *,
                 label: str | None = None) -> np.ndarray:
    """``jax.lax.psum_scatter(..., tiled=True)`` over ``axes``: lane k of
    a group gets the sum over the group, in its index order, of every
    lane's k-th chunk along ``dim``.  Its backward, an ``all_gather``, is
    counted as an ``all-gather``."""
    n = math.prod(mesh.shape[a] for a in _axes(axes))
    if n == 1:  # a group of one lane: nothing moves
        return parts
    size = parts.flat[0].shape[dim]
    if size % n:
        raise ValueError(f"psum_scatter: dim {dim} of size {size} does not "
                         f"split into {n} chunks")
    size //= n

    def make(group, k, dst, made):
        home = mesh.devices[dst]
        total = parts[group[0]].narrow(dim, k * size, size).to(home)
        for src in group[1:]:
            total = total + parts[src].narrow(dim, k * size, size).to(home)
        return total
    return _record("reduce-scatter", _collect(parts, axes, mesh, make),
                   back="all-gather", back_scale=(n, 1), label=label)
