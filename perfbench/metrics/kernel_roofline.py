"""The kernels' share of the bandwidth roofline: the bytes the SpMV needs
(perfbench/roofline.py) at the device's HBM peak (perfbench/peaks.json),
over the device time of all kernels in the traced window (memcpys and
memsets not counted).  Nothing when the device has no row of peaks."""
from perfbench.roofline import iteration_bytes


def read(run):
    if run.trace is None or run.peaks is None or run.trace.kernel_s <= 0:
        return None
    g = run.graph
    need = sum(iteration_bytes(s.edges_processed, req.jobs,
                               s.shards_skipped == 0, g.n_src, g.n_dst,
                               g.weighted)
               for req, s in run.stats)
    return 100.0 * need / run.peaks["hbm_bytes_per_s"] / run.trace.kernel_s
