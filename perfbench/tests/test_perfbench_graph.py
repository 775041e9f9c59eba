"""The generated graph is the one Graph500's specification defines: 2**SCALE
vertices with permuted labels, every edge stored both ways, search keys of
degree >= 1 not counting self-loops; and the same seed gives the same
files."""
from __future__ import annotations

import json

import numpy as np

from perfbench import data, rmat

G = {"generator": "graph500", "scale": 10, "edge_factor": 16, "a": 0.57,
     "b": 0.19, "c": 0.19, "seed": 0}


def _graph(root, weights="unit"):
    config = {"graph": G, "weights": weights, "weight_seed": 1}
    files = data.ensure_graph(config, root)
    return files, data.load_edges(files)


def test_counts_and_both_directions(tmp_path):
    files, (src, dst, w) = _graph(tmp_path)
    assert files.num_vertices == 1 << 10
    assert files.num_edges == 16 << 10 and files.num_arcs == 32 << 10
    assert src.shape == dst.shape == (files.num_arcs,) and w is None
    n = files.num_vertices
    fwd = np.sort(src * n + dst)
    assert np.array_equal(fwd, np.sort(dst * n + src))
    meta = json.loads((files.edge_dir / "meta.json").read_text())
    assert meta["num_vertices"] == n and meta["num_edges"] == files.num_arcs


def test_labels_are_permuted():
    """Without the permutation vertex 0 is the Kronecker graph's hub; with
    it the hub sits anywhere and the labels are a permutation of the raw
    ones (the same degrees)."""
    raw = [np.concatenate(p) for p in zip(*rmat.rmat_edges(10, seed=0))]
    src, dst = rmat.graph500_edges(10, seed=0)
    deg_raw = np.bincount(np.concatenate(raw), minlength=1 << 10)
    deg = np.bincount(np.concatenate([src, dst]), minlength=1 << 10)
    assert deg_raw.argmax() == 0 and deg.argmax() != 0
    assert np.array_equal(np.sort(deg_raw), np.sort(deg))
    again = rmat.graph500_edges(10, seed=0)
    assert np.array_equal(src, again[0]) and np.array_equal(dst, again[1])
    assert not np.array_equal(src, rmat.graph500_edges(10, seed=1)[0])


def test_search_keys_have_degree_without_self_loops(tmp_path):
    files, (src, dst, _) = _graph(tmp_path)
    pool = np.load(files.pool)
    other = src != dst
    want = np.unique(src[other])
    assert np.array_equal(pool, want)
    loops_only = np.setdiff1d(np.unique(src[~other]), want)
    assert not np.isin(loops_only, pool).any()


def test_both_arcs_of_an_edge_share_a_weight(tmp_path):
    files, (src, dst, w) = _graph(tmp_path, "uniform01")
    assert files.weighted and w.dtype == np.float32
    n = files.num_vertices
    # an arc's weight is among the weights of its reverse arcs
    key = src * n + dst
    back = dst * n + src
    order = np.lexsort((w, key))
    k_sorted, w_sorted = key[order], w[order]
    order_b = np.lexsort((w, back))
    assert np.array_equal(k_sorted, back[order_b])
    assert np.array_equal(w_sorted, w[order_b])
