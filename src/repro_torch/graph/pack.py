"""CLI converter: npz graph directory -> packed single-file format.

    python -m repro_torch.graph.pack GRAPH_DIR [OUT_FILE]

OUT_FILE defaults to GRAPH_DIR/packed.gmpk.  The packed file is the
zero-copy mmap backend consumed by ``GraphSession(path, backend="packed")``
(see repro_torch/graph/packed.py for the layout; the bytes are the
reference package's, so either package opens a file the other wrote).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.graph.packed import DEFAULT_PACKED_NAME, pack_graph
from repro_torch.graph.source import MissingGraphError
from repro_torch.graph.storage import GraphStore


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.graph.pack",
        description="Pack a preprocessed graph directory into one mmap-able "
                    "file (zero-copy shard views).")
    ap.add_argument("graph_dir", help="preprocessed graph directory "
                                      "(output of preprocess_graph)")
    ap.add_argument("out_file", nargs="?", default=None,
                    help=f"output file (default: GRAPH_DIR/{DEFAULT_PACKED_NAME})")
    args = ap.parse_args(argv)
    store = GraphStore(args.graph_dir)
    try:
        out = pack_graph(store, args.out_file)
    except MissingGraphError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    size = Path(out).stat().st_size
    print(f"packed {store.num_shards} shards, |V|={store.num_vertices}, "
          f"|E|={store.num_edges} -> {out} ({size / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
