"""PageRank: ranks after the job's iterations (``max_iters``, ``damping``
from its arguments), held against the reference in float64 by the largest
relative error of any vertex's rank."""
from perfbench import reference as ref

CHECK = "pagerank_rel_err"


def reference(graph, jobs, precision=None):
    out, done = [], {}
    for j in jobs:
        key = (tuple(sorted(j.args.items())), j.max_iters)
        if key not in done:
            done[key] = ref.pagerank(graph, max_iters=j.max_iters,
                                     precision=precision or "float64",
                                     **j.args)
        out.append(done[key])
    return out


compare = ref.max_rel_err
