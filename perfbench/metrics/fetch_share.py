"""Share of the iterations' seconds spent fetching shards from the edge
cache and staging them on the device (IterationStats.fetch_seconds over
IterationStats.seconds), over the completed jobs."""


def read(run):
    seconds = sum(s.seconds for _, s in run.stats)
    if seconds <= 0:
        return None
    return 100.0 * sum(s.fetch_seconds for _, s in run.stats) / seconds
