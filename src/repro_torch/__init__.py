"""GraphMP in PyTorch: the same system as the ``repro`` package (its JAX
reference), with the SpMV hot loop in hand-written CUDA kernels for Hopper.

    from repro_torch import GraphSession, preprocess_graph, write_edge_list

    write_edge_list(edges_dir, [(src, dst)])
    preprocess_graph(edges_dir, graph_dir)
    with GraphSession(graph_dir) as s:          # device="cuda" by default
        pr = s.run("pagerank", max_iters=30)

This package imports torch and numpy, never jax and nothing of ``repro``;
both packages read and write the same preprocessed stores and checkpoints.
"""
from repro_torch.core.apps import (BatchedVertexProgram,  # noqa: F401
                                   VertexProgram, available_apps, get_app,
                                   register_app)
from repro_torch.core.cache import CompressedShardCache  # noqa: F401
from repro_torch.core.engine import (BatchRunResult, EngineConfig,  # noqa: F401
                                     IterationStats, RunResult, VSWEngine)
from repro_torch.core.pipeline import ShardPipeline  # noqa: F401
from repro_torch.graph.compact import CompactionReport, compact  # noqa: F401
from repro_torch.graph.delta import DeltaBudgetError, DeltaGraphStore  # noqa: F401
from repro_torch.graph.generate import (materialize, rmat_edges,  # noqa: F401
                                        uniform_edges, zipf_edges)
from repro_torch.graph.memory import MemoryGraphStore  # noqa: F401
from repro_torch.graph.packed import PackedGraphStore, pack_graph  # noqa: F401
from repro_torch.graph.preprocess import preprocess_graph  # noqa: F401
from repro_torch.graph.source import (ConcurrentMutationError,  # noqa: F401
                                      MissingGraphError, ShardSource)
from repro_torch.graph.storage import GraphStore, write_edge_list  # noqa: F401
from repro_torch.session import GraphSession  # noqa: F401

__all__ = sorted([
    "BatchRunResult", "BatchedVertexProgram", "CompactionReport",
    "CompressedShardCache", "ConcurrentMutationError", "DeltaBudgetError",
    "DeltaGraphStore", "EngineConfig", "GraphSession", "GraphStore",
    "IterationStats", "MemoryGraphStore", "MissingGraphError",
    "PackedGraphStore", "RunResult", "ShardPipeline", "ShardSource",
    "VSWEngine", "VertexProgram", "available_apps", "compact", "get_app",
    "materialize", "pack_graph", "preprocess_graph", "register_app",
    "rmat_edges", "uniform_edges", "write_edge_list", "zipf_edges",
])
