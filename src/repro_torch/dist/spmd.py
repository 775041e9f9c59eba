"""Lane-by-lane SPMD: the port's counterpart of ``jax.shard_map`` and of
the ``jax.lax`` collectives, over a ``dist.context.Mesh`` in one process.

A value split over a mesh is a numpy object array of the mesh's shape
holding one tensor per lane (``shard``); ``lanewise`` runs a function on
each lane's tensors, and the collectives move tensors between lanes
explicitly (``.to(lane)``, ``torch.cat``, sums), so autograd trains
through them with no custom backward.  Lanes on one device move nothing:
``shard`` hands out views and ``.to`` to the same device is the tensor
itself.

Every collective computes its result once per group of lanes, in the
order of the lanes' index along the reduced axes, and hands that result to
each lane of the group: every lane holds the same value, as an all-reduce
gives.

``count_collectives()`` records, while it is active, each collective's
per-lane result bytes by the kind names of XLA's HLO (``psum`` and
``pmax`` are an ``all-reduce``, ``pmean`` its ``psum`` once,
``all_to_all`` an ``all-to-all``), and the bytes of each one's
transpose when autograd runs it backward (the gradient of a lane's
result, under the same kind).  Inactive, it costs one test a call.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.dist.context import Mesh, PartitionSpec


# the active counter of this thread or task, if any
_counts: contextvars.ContextVar[dict[str, int] | None] = \
    contextvars.ContextVar("collective_counts", default=None)


@contextlib.contextmanager
def count_collectives():
    """-> a dict {kind: per-lane result bytes} that the collectives run
    inside the block (and their backward passes) add to.  A lane's bytes
    are those of lane 0's result: every lane of a mesh joins each
    collective with a result of the same shape."""
    counts: dict[str, int] = {}
    token = _counts.set(counts)
    try:
        yield counts
    finally:
        _counts.reset(token)


def _record(kind: str, out: np.ndarray) -> np.ndarray:
    counts = _counts.get()
    if counts is None:
        return out
    lane = out.flat[0]
    counts[kind] = counts.get(kind, 0) + lane.numel() * lane.element_size()
    if lane.requires_grad:
        def backward(grad):
            counts[kind] = counts.get(kind, 0) + \
                grad.numel() * grad.element_size()
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


def lanewise(fn: Callable, *args):
    """``fn`` on each lane: every argument that is a lanes array gives
    its lane's entry, any other is passed as it is.  -> a lanes array, or
    a tuple of them when ``fn`` returns a tuple."""
    shape = next(a.shape for a in args if isinstance(a, np.ndarray))
    results = {}
    for idx in np.ndindex(shape):
        results[idx] = fn(*(a[idx] if isinstance(a, np.ndarray) else a
                            for a in args))
    first = next(iter(results.values()))
    n = len(first) if isinstance(first, tuple) else None
    outs = [np.empty(shape, dtype=object) for _ in range(n or 1)]
    for idx, res in results.items():
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


def _reduce(parts: np.ndarray, axes, mesh: Mesh, op) -> np.ndarray:
    axes = _axes(axes)
    out = np.empty(parts.shape, dtype=object)
    for group in _groups(mesh, axes):
        home = mesh.devices[group[0]]
        total = parts[group[0]]
        for idx in group[1:]:
            total = op(total, parts[idx].to(home))
        for idx in group:
            out[idx] = total.to(mesh.devices[idx])
    return out


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
               concat_axis: int, mesh: Mesh) -> np.ndarray:
    """``jax.lax.all_to_all(..., tiled=True)`` over one mesh axis of n
    lanes: each lane cuts its tensor into n chunks along ``split_axis``,
    chunk k goes to lane k, and each lane concatenates what it receives
    along ``concat_axis`` in the senders' index order."""
    out = np.empty(parts.shape, dtype=object)
    n = mesh.shape[axis]
    for group in _groups(mesh, (axis,)):
        size = parts[group[0]].shape[split_axis]
        if size % n:
            raise ValueError(f"all_to_all: dim {split_axis} of size {size} "
                             f"does not split into {n} chunks")
        size //= n
        for k, dst in enumerate(group):
            dev = mesh.devices[dst]
            out[dst] = torch.cat(
                [parts[src].narrow(split_axis, k * size, size).to(dev)
                 for src in group], concat_axis)
    return _record("all-to-all", out)
