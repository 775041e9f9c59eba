"""The plain reference of both configurations: the graph applications in
plain PyTorch over the edge list the benchmark generated.

It imports nothing of the program and reads none of its files.  The
semantics are the program's, written out directly (edges pull along their
direction, source to destination):

- ``sssp`` / ``bfs``: the min-plus fixpoint, dist[v] = min(dist[v],
  dist[u] + w(u, v)), from dist[root] = 0; BFS takes w = 1.  In float32 the
  fixpoint is the minimum over paths of the left-to-right float32 sums, the
  same whatever order relaxations run in, so the comparison is exact.
- ``cc``: labels start at the vertex id and take the minimum over in-edges
  until nothing changes (the label is the smallest id that reaches v).
- ``pagerank``: pr[v] = (1 - d) / n + d * sum over in-edges u -> v of
  pr[u] / max(outdeg(u), 1), from 1 / n, for ``max_iters`` iterations or
  until no vertex moves by more than ``tol`` of its value; in float64.

``precision="bfloat16"`` runs the same arithmetic with every value and
weight rounded to bfloat16 after each operation (sums of PageRank
accumulate in float32): the control of the comparison.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# edges a step of the relaxation touches at once: bounds the [chunk, K]
# temporaries to about 1 GiB at K = 64
EDGE_CHUNK = 1 << 22


@dataclasses.dataclass
class Graph:
    src: torch.Tensor          # int64 [E]
    dst: torch.Tensor          # int64 [E]
    weights: torch.Tensor | None  # float32 [E] or None (unit values)
    n: int

    @classmethod
    def from_numpy(cls, src: np.ndarray, dst: np.ndarray,
                   weights: np.ndarray | None, n: int,
                   device: torch.device) -> "Graph":
        w = None if weights is None else torch.from_numpy(
            np.ascontiguousarray(weights, dtype=np.float32)).to(device)
        return cls(torch.from_numpy(src).to(device),
                   torch.from_numpy(dst).to(device), w, n)


def _round(t: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return t
    if precision == "bfloat16":
        return t.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"unknown precision {precision!r}")


def _active_edges(g: Graph, active: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(active[g.src]).squeeze(1)


def min_plus(g: Graph, sources, unit: bool, precision: str = "float32",
             max_iters: int | None = None) -> tuple[torch.Tensor, int]:
    """-> (dist [n, K] float32, iterations that changed something)."""
    k = len(sources)
    dev = g.src.device
    cols = torch.arange(k, device=dev)
    srcs = torch.as_tensor(list(sources), dtype=torch.int64, device=dev)
    dist = torch.full((g.n, k), float("inf"), device=dev)
    dist[srcs, cols] = 0.0
    active = torch.zeros(g.n, dtype=torch.bool, device=dev)
    active[srcs] = True
    w_all = None if unit else _round(g.weights, precision)
    levels = 0
    while max_iters is None or levels < max_iters:
        idx = _active_edges(g, active)
        if idx.numel() == 0:
            break
        new = dist.clone()
        for part in idx.split(EDGE_CHUNK):
            s, d = g.src[part], g.dst[part]
            w = 1.0 if unit else w_all[part, None]
            cand = _round(dist[s] + w, precision)
            new.scatter_reduce_(0, d[:, None].expand(-1, k), cand, "amin")
        changed = new < dist
        active = changed.any(dim=1)
        dist = new
        if not bool(active.any()):
            break
        levels += 1
    return dist, levels


def min_plus_short(g: Graph, sources, unit: bool) -> torch.Tensor:
    """-> dist [n, K], the float32 relaxation stopped one iteration short of
    its fixpoint: the answer of a run that ends one level early."""
    _, levels = min_plus(g, sources, unit)
    dist, _ = min_plus(g, sources, unit, max_iters=max(levels - 1, 0))
    return dist


def cc(g: Graph, precision: str = "float32") -> torch.Tensor:
    """-> labels [n] float32."""
    dev = g.src.device
    label = _round(torch.arange(g.n, dtype=torch.float32, device=dev),
                   precision)
    active = torch.ones(g.n, dtype=torch.bool, device=dev)
    while True:
        idx = _active_edges(g, active)
        if idx.numel() == 0:
            break
        new = label.clone()
        for part in idx.split(EDGE_CHUNK):
            new.scatter_reduce_(0, g.dst[part], label[g.src[part]], "amin")
        active = new < label
        label = new
        if not bool(active.any()):
            break
    return label


def pagerank(g: Graph, damping: float = 0.85, max_iters: int = 10,
             tol: float = 1e-6, precision: str = "float64") -> torch.Tensor:
    """-> ranks [n] (float64, or float32 after bfloat16 rounding)."""
    dev = g.src.device
    low = precision == "bfloat16"
    if not low and precision != "float64":
        raise ValueError(f"unknown precision {precision!r}")
    acc_dtype = torch.float32 if low else torch.float64
    outdeg = torch.bincount(g.src, minlength=g.n).clamp(min=1).to(acc_dtype)
    pr = torch.full((g.n,), 1.0 / g.n, dtype=acc_dtype, device=dev)
    if low:
        pr = _round(pr, "bfloat16")
    for _ in range(max_iters):
        x = pr / outdeg
        if low:
            x = _round(x, "bfloat16")
        acc = torch.zeros(g.n, dtype=acc_dtype, device=dev)
        for lo in range(0, g.src.numel(), EDGE_CHUNK):
            hi = lo + EDGE_CHUNK
            acc.index_add_(0, g.dst[lo:hi], x[g.src[lo:hi]])
        new = (1.0 - damping) / g.n + damping * acc
        if low:
            new = _round(new, "bfloat16")
        moved = (new - pr).abs() > tol * pr.abs() + 1e-30
        pr = new
        if not bool(moved.any()):
            break
    return pr


# -- comparisons ---------------------------------------------------------
def count_wrong(got: torch.Tensor, want: torch.Tensor) -> int:
    """Values that differ (an unreached vertex is inf on both sides)."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    return int((~same).sum())


def max_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.to(torch.float64)
    err = (got.to(torch.float64) - want).abs() / want.abs()
    err = torch.where(torch.isnan(err), torch.full_like(err, float("inf")),
                      err)
    return float(err.max())
