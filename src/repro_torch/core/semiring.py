"""Semirings for vertex-centric pull-mode updates (Algorithm 3, vectorized).

A GraphMP ``Update`` function factors into three pieces:

  partial[v] = REDUCE_{(u,v) in shard}  COMBINE(edge_val(u,v), src[u])
  dst[v]     = POST(partial[v], old[v], aux)

PageRank : REDUCE=+,   COMBINE=(w, s) -> s            POST = 0.15/n + 0.85*p
SSSP     : REDUCE=min, COMBINE=(w, s) -> s + w        POST = min(p, old)
CC       : REDUCE=min, COMBINE=(w, s) -> s            POST = min(p, old)
BFS      : REDUCE=min, COMBINE=(w, s) -> s + 1        POST = min(p, old)
LP       : REDUCE=max, COMBINE=(w, s) -> s            POST = max(p, old)

The semiring is the device-side contract shared by the plain torch version
(``kernels/spmv/ref.py``), the CUDA kernels (``kernels/spmv/csrc``, where
``SEMIRING_IDS`` numbers them) and the VSW engine.  ``identity`` is the
REDUCE identity and is what padded (sentinel) ELL slots must contribute.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    # reduce(a, b) -> elementwise monoid used to fold the ELL width dim
    reduce: Callable[[Tensor, Tensor], Tensor]
    # combine(edge_val, src_val) -> contribution of one edge
    combine: Callable[[Tensor, Tensor], Tensor]
    # identity element of `reduce` (what masked slots contribute)
    identity: float
    # whether `reduce` is `+`
    is_plus: bool = False
    # whether `reduce` is `max` (the non-plus default is `min`, the
    # propagation direction of sssp/bfs/cc; label propagation flips it)
    is_max: bool = False

    def fold(self, edge_vals: Tensor, src_vals: Tensor, mask: Tensor,
             dim: int = -1) -> Tensor:
        """Reduce COMBINE(edge, src) over ``dim``, treating ~mask as identity."""
        contrib = self.combine(edge_vals, src_vals).masked_fill(~mask,
                                                                self.identity)
        if self.is_plus:
            return torch.sum(contrib, dim=dim)
        if self.is_max:
            return torch.amax(contrib, dim=dim)
        return torch.amin(contrib, dim=dim)

    def fold_batch(self, edge_vals: Tensor, src_vals: Tensor,
                   mask: Tensor) -> Tensor:
        """Batched fold: one edge pass serves K value columns.

        ``edge_vals``/``mask`` are [R, W] (shared by every column);
        ``src_vals`` is [R, W, K].  COMBINE sees edge [R, W, 1] against
        source [R, W, K]; reduces the ELL width dim -> [R, K]."""
        return self.fold(edge_vals[..., None], src_vals, mask[..., None],
                         dim=1)


PLUS_TIMES = Semiring(
    name="plus_times",
    reduce=torch.add,
    combine=lambda w, s: w * s,
    identity=0.0,
    is_plus=True,
)

# PageRank pulls src/out_deg along in-edges; the division is folded into the
# gather-transform, so on the shard the combine is just "take the source".
PLUS_SRC = Semiring(
    name="plus_src",
    reduce=torch.add,
    combine=lambda w, s: s,
    identity=0.0,
    is_plus=True,
)

MIN_PLUS = Semiring(
    name="min_plus",
    reduce=torch.minimum,
    combine=lambda w, s: w + s,
    identity=float("inf"),
)

MIN_SRC = Semiring(
    name="min_src",
    reduce=torch.minimum,
    combine=lambda w, s: s,
    identity=float("inf"),
)

# Label propagation pulls the neighbor's label and keeps the largest; -inf is
# the identity so sentinel ELL slots (and vertices with no in-edges) never win.
MAX_SRC = Semiring(
    name="max_src",
    reduce=torch.maximum,
    combine=lambda w, s: s,
    identity=float("-inf"),
    is_max=True,
)

SEMIRINGS = {s.name: s for s in (PLUS_TIMES, PLUS_SRC, MIN_PLUS, MIN_SRC, MAX_SRC)}

# numbering shared with the kernels' ``semiring`` argument (csrc/ell_spmv.cu)
SEMIRING_IDS = {name: i for i, name in enumerate(SEMIRINGS)}
