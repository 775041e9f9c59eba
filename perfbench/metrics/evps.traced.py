"""evps.traced: Graphalytics' edges plus vertices per second, read in the
traced run (the profiler on).

Each job completed in the window counts the graph's |V| + |E| (a batch of
K counts K jobs), over the seconds from the window's start to the last
completion in it; a job that the window's end cuts off counts neither work
nor time.  The roots a seed draws change the time, never the work counted.
"""


def read(run):
    if not run.completed:
        return None
    return run.jobs * run.graph.work_per_job / run.t_last
