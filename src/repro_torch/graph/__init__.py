from repro_torch.graph.generate import (materialize, rmat_edges,  # noqa: F401
                                        uniform_edges, zipf_edges)
from repro_torch.graph.source import (BytesCounter,  # noqa: F401
                                      ConcurrentMutationError,
                                      MissingGraphError, ShardSource,
                                      graph_token)
from repro_torch.graph.storage import GraphStore  # noqa: F401
from repro_torch.graph.packed import PackedGraphStore, pack_graph  # noqa: F401
from repro_torch.graph.memory import MemoryGraphStore  # noqa: F401
from repro_torch.graph.preprocess import preprocess_graph  # noqa: F401
from repro_torch.graph.delta import DeltaBudgetError, DeltaGraphStore  # noqa: F401
from repro_torch.graph.compact import CompactionReport, compact  # noqa: F401
