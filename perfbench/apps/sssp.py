"""SSSP (Graph500 kernel 3): the distance of every vertex from one root,
the float32 min-plus (Bellman-Ford) fixpoint over the graph's weights
(unit weights where the graph has none).  Exact: every distance equals the
reference's, bit for bit."""
from perfbench import reference as ref

CHECK = "sssp_wrong"


def reference(graph, jobs, precision=None):
    dist, _ = ref.min_plus(graph, [j.source for j in jobs],
                           graph.weights is None, precision or "float32")
    return dist.unbind(1)


def short(graph, jobs):
    """The reference stopped one level short of its fixpoint."""
    return ref.min_plus_short(graph, [j.source for j in jobs],
                              graph.weights is None).unbind(1)


compare = ref.count_wrong
