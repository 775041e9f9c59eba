"""The Graph500 Kronecker (RMAT) edge generator, frozen for the benchmark.

``rmat_edges`` is a copy of ``repro_torch.graph.generate.rmat_edges``: the
benchmark's inputs must not move when the program's generator changes.
``graph500_edges`` adds what the Graph500 specification's generator does
after the Kronecker draw: it permutes the vertex labels and shuffles the
edge tuples.  Deterministic in ``seed``.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def rmat_edges(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    chunk: int = 1 << 22,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Stream RMAT (Graph500 parameters) edges as (src, dst) chunks.

    2**scale vertices, edge_factor * 2**scale edges (with duplicates and
    self-loops, like real crawls).
    """
    n_edges = edge_factor << scale
    rng = np.random.default_rng(seed)
    cdf = np.array([a, b, c, 1.0 - a - b - c]).cumsum()
    cdf /= cdf[-1]
    # ids fit int32 up to scale 31; half the bytes of int64 in every pass
    word = np.int32 if scale <= 31 else np.int64
    emitted = 0
    while emitted < n_edges:
        m = min(chunk, n_edges - emitted)
        src = np.zeros(m, dtype=word)
        dst = np.zeros(m, dtype=word)
        q = np.empty(m, dtype=word)
        bit = np.empty(m, dtype=word)
        for _ in range(scale):
            # the quadrant rng.choice(4, size=m, p=probs) draws from the
            # same stream: one uniform each, then the number of cdf
            # entries <= it (cdf[3] is 1.0, above every uniform)
            u = rng.random(m)
            np.greater_equal(u, cdf[0], out=q, casting="unsafe")
            q += u >= cdf[1]
            q += u >= cdf[2]
            src <<= 1
            src |= np.right_shift(q, 1, out=bit)
            dst <<= 1
            dst |= np.bitwise_and(q, 1, out=bit)
        yield src.astype(np.int64), dst.astype(np.int64)
        emitted += m


def graph500_edges(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """-> (src, dst) int64, the whole edge list of Graph500's generator.

    The Kronecker tuples of ``rmat_edges``, then the 2**scale vertex labels
    permuted and the tuples shuffled, both drawn from ``seed`` on a stream
    of their own, so that no hub sits at a low id and no run of tuples
    shares a quadrant.  Each tuple is one undirected edge.
    """
    parts = list(rmat_edges(scale, edge_factor, a, b, c, seed))
    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    del parts
    rng = np.random.default_rng([seed, 1])
    label = rng.permutation(1 << scale)
    order = rng.permutation(src.shape[0])
    return label[src[order]], label[dst[order]]
