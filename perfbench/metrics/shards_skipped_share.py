"""Share of shard visits the schedule skipped (Bloom-filter selective
scheduling), over the program's IterationStats of the completed jobs."""


def read(run):
    skipped = sum(s.shards_skipped for _, s in run.stats)
    total = skipped + sum(s.shards_processed for _, s in run.stats)
    if total == 0:
        return None
    return 100.0 * skipped / total
