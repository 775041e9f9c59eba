"""CC: every vertex's label, the smallest id that reaches it, as the
min-label fixpoint over in-edges.  Exact: every label equals the
reference's."""
from perfbench import reference as ref

CHECK = "cc_wrong"


def reference(graph, jobs, precision=None):
    labels = ref.cc(graph, precision or "float32")
    return [labels for _ in jobs]


compare = ref.count_wrong
