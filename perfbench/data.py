"""The benchmark's inputs on disk: the edge list it generates and the store
the program preprocesses from it.

Both live in fixed directories under ``perfbench/_data`` (ignored by git),
named by a hash of what made them, so the first run of a configuration in
a checkout writes them and every later run reuses them.  A directory is
built under a ``.partial`` name and renamed when complete, so a run cut off
half way leaves nothing that a later run would trust.

The edge list is the reference's input too: the reference reads these
files, never the program's store.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from pathlib import Path

import numpy as np

from perfbench.rmat import graph500_edges

DATA = Path(__file__).resolve().parent / "_data"
CHUNK = 1 << 22
# the layout of the generated files; part of every directory's key
LAYOUT = 3


@dataclasses.dataclass(frozen=True)
class GraphFiles:
    edge_dir: Path      # meta.json, edges_*.npy (+ weights_*.npy)
    num_vertices: int   # N = 2**scale
    num_edges: int      # M, the undirected edges (Graph500's tuples)
    num_arcs: int       # 2M, each edge stored once in each direction
    weighted: bool
    n_src: int          # vertices with an out-arc
    n_dst: int          # vertices with an in-arc
    pool: Path          # int32 ids with degree >= 1 not counting self-loops

    @property
    def work_per_job(self) -> int:
        """Graphalytics' work unit of one job: |V| + |E|, each undirected
        edge counted once."""
        return self.num_vertices + self.num_edges


def _key(*parts) -> str:
    blob = json.dumps((LAYOUT,) + parts, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def _publish(partial: Path, final: Path) -> None:
    if final.exists():  # an incomplete directory from an older layout
        shutil.rmtree(final)
    os.replace(partial, final)


def _fresh(partial: Path) -> Path:
    if partial.exists():
        shutil.rmtree(partial)
    partial.mkdir(parents=True)
    return partial


def ensure_graph(config: dict, root: Path = DATA) -> GraphFiles:
    """The configuration's edge list, generated on first use."""
    g = config["graph"]
    if g["generator"] != "graph500":
        raise ValueError(f"unknown generator {g['generator']!r}")
    gdir = root / f"graph-{_key(g)}"
    if not (gdir / "info.json").is_file():
        _generate(g, gdir)
    with open(gdir / "info.json") as f:
        info = json.load(f)
    edge_dir = gdir
    weighted = config.get("weights", "unit") != "unit"
    if weighted:
        edge_dir = _weighted_edges(config, gdir, root)
    return GraphFiles(edge_dir, info["num_vertices"], info["num_edges"],
                      info["num_arcs"], weighted, info["n_src"],
                      info["n_dst"], gdir / "pool.npy")


def _generate(g: dict, gdir: Path) -> None:
    """Graph500's edge list, each edge written in both directions: kernel 1
    builds an undirected graph, and a search follows an edge either way.
    A file holds the two arcs of ``CHUNK`` edges, so the weights of a file
    (``_weighted_edges``) give both arcs of an edge the same value."""
    partial = _fresh(gdir.with_name(gdir.name + ".partial"))
    n = 1 << int(g["scale"])
    src, dst = graph500_edges(int(g["scale"]), int(g["edge_factor"]),
                              a=g["a"], b=g["b"], c=g["c"],
                              seed=int(g["seed"]))
    degree = np.zeros(n, dtype=np.int64)  # not counting self-loops
    files = []
    for i, lo in enumerate(range(0, src.shape[0], CHUNK)):
        s, d = src[lo:lo + CHUNK], dst[lo:lo + CHUNK]
        name = f"edges_{i:05d}.npy"
        np.save(partial / name, np.stack([np.concatenate([s, d]),
                                          np.concatenate([d, s])]))
        files.append(name)
        loop = s == d
        degree += np.bincount(s[~loop], minlength=n)
        degree += np.bincount(d[~loop], minlength=n)
    ends = np.zeros(n, dtype=bool)
    ends[src] = True
    ends[dst] = True
    m = int(src.shape[0])
    # Graph500's search keys: degree >= 1, not counting self-loops
    np.save(partial / "pool.npy", np.flatnonzero(degree > 0).astype(np.int32))
    with open(partial / "meta.json", "w") as f:
        json.dump({"num_vertices": n, "num_edges": 2 * m, "files": files,
                   "weighted": False}, f)
    # an undirected graph: a vertex with an out-arc has an in-arc
    with open(partial / "info.json", "w") as f:
        json.dump({"graph": g, "num_vertices": n, "num_edges": m,
                   "num_arcs": 2 * m, "n_src": int(ends.sum()),
                   "n_dst": int(ends.sum())}, f)
    _publish(partial, gdir)


def _weighted_edges(config: dict, gdir: Path, root: Path) -> Path:
    """An edge-list directory over the same edge files (symlinks) with the
    configuration's weights beside them: one draw an edge, the same for
    both of its arcs."""
    kind = config["weights"]
    if kind != "uniform01":
        raise ValueError(f"unknown weights {kind!r}")
    seed = int(config["weight_seed"])
    wdir = root / f"weights-{_key(config['graph'], kind, seed)}"
    if (wdir / "meta.json").is_file():
        return wdir
    partial = _fresh(wdir.with_name(wdir.name + ".partial"))
    with open(gdir / "meta.json") as f:
        meta = json.load(f)
    rng = np.random.default_rng(seed)
    for name in meta["files"]:
        (partial / name).symlink_to(os.path.relpath(gdir / name, wdir))
        m = np.load(gdir / name, mmap_mode="r").shape[1] // 2
        w = rng.random(m, dtype=np.float32)
        np.save(partial / name.replace("edges_", "weights_"),
                np.concatenate([w, w]))
    meta["weighted"] = True
    with open(partial / "meta.json", "w") as f:
        json.dump(meta, f)
    _publish(partial, wdir)
    return wdir


def ensure_store(config: dict, graph: GraphFiles, root: Path = DATA) -> Path:
    """The program's store, preprocessed from the edge list on first use
    with the configuration's ``preprocess`` settings."""
    from repro_torch.graph.preprocess import preprocess_graph

    key = _key(config["graph"], config.get("weights"),
               config.get("weight_seed"), config["preprocess"])
    sdir = root / f"store-{key}"
    if (sdir / "property.json").is_file():
        return sdir
    partial = _fresh(sdir.with_name(sdir.name + ".partial"))
    preprocess_graph(str(graph.edge_dir), str(partial), **config["preprocess"])
    _publish(partial, sdir)
    return sdir


def load_edges(graph: GraphFiles):
    """-> (src, dst, weights or None) as numpy arrays, the whole edge list."""
    with open(graph.edge_dir / "meta.json") as f:
        meta = json.load(f)
    parts = [np.load(graph.edge_dir / name) for name in meta["files"]]
    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    del parts
    w = None
    if meta.get("weighted"):
        w = np.concatenate([np.load(graph.edge_dir / name.replace(
            "edges_", "weights_")) for name in meta["files"]])
    return src, dst, w
