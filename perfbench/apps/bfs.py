"""BFS (Graph500 kernel 2): the hop count of every vertex from one root,
the min-plus fixpoint over unit weights.  Exact: every hop count equals the
reference's.  Hop counts up to 256 are exact in bfloat16 too, so unit BFS
cannot tell the stated float32 from bfloat16; its control stops one level
short of the fixpoint instead (``short``)."""
from perfbench import reference as ref

CHECK = "bfs_wrong"


def reference(graph, jobs, precision=None):
    dist, _ = ref.min_plus(graph, [j.source for j in jobs], True,
                           precision or "float32")
    return dist.unbind(1)


def short(graph, jobs):
    """The reference stopped one level short of its fixpoint."""
    return ref.min_plus_short(graph, [j.source for j in jobs], True).unbind(1)


compare = ref.count_wrong
