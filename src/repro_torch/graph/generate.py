"""Synthetic power-law graph generators.

The paper's datasets (Twitter/UK-2007/UK-2014/EU-2015, up to 91.8B edges,
law.di.unimi.it) are not available offline; benchmarks use RMAT and Zipf
generators with matched degree skew (all four paper graphs are power-law,
Fig. 6).  Generators are deterministic in `seed` and stream in chunks so a
graph larger than host memory can be written straight to disk.
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


def zipf_edges(
    num_vertices: int,
    num_edges: int,
    alpha: float = 1.3,
    seed: int = 0,
    chunk: int = 1 << 22,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Edges with Zipf-distributed destinations (heavy in-degree skew, like
    the paper's web crawls whose max in-degree is ~20M on 1.1B vertices)."""
    rng = np.random.default_rng(seed)
    # Zipf ranks via inverse-CDF on a truncated harmonic distribution
    ranks = np.arange(1, num_vertices + 1, dtype=np.float64)
    w = ranks ** (-alpha)
    cdf = np.cumsum(w) / w.sum()
    emitted = 0
    while emitted < num_edges:
        m = min(chunk, num_edges - emitted)
        u = rng.random(m)
        dst = np.searchsorted(cdf, u).astype(np.int64)
        src = rng.integers(0, num_vertices, size=m, dtype=np.int64)
        yield src, dst
        emitted += m


def uniform_edges(
    num_vertices: int, num_edges: int, seed: int = 0, chunk: int = 1 << 22
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    emitted = 0
    while emitted < num_edges:
        m = min(chunk, num_edges - emitted)
        yield (
            rng.integers(0, num_vertices, size=m, dtype=np.int64),
            rng.integers(0, num_vertices, size=m, dtype=np.int64),
        )
        emitted += m


def materialize(gen: Iterator[tuple[np.ndarray, np.ndarray]]) -> tuple[np.ndarray, np.ndarray]:
    srcs, dsts = [], []
    for s, d in gen:
        srcs.append(s)
        dsts.append(d)
    return np.concatenate(srcs), np.concatenate(dsts)
