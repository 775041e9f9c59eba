"""The bytes the SpMV of one iteration needs, for kernel roofline shares.

Counted from what the inputs need, each byte once, never from what a
kernel happens to move: each processed edge's source index (int32), and
its value where the graph has real weights (unit values need none); on a
sweep over every shard, the frontier values of every vertex with an
out-edge read once and the values of every vertex with an in-edge written
once, K float32 columns each.  A selective sweep counts its edges alone,
since which vertices it reads and writes is not observed.  So the count is
a floor of the work, and a share of the roofline cannot pass 100%.
"""
from __future__ import annotations

INDEX_BYTES = 4
VALUE_BYTES = 4


def iteration_bytes(edges: int, k: int, full_sweep: bool, n_src: int,
                    n_dst: int, weighted: bool) -> int:
    b = edges * (INDEX_BYTES + (VALUE_BYTES if weighted else 0))
    if full_sweep:
        b += (n_src + n_dst) * k * VALUE_BYTES
    return b
