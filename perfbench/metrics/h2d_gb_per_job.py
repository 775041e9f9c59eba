"""Host-to-device bytes per completed job, in GB (1e9 bytes): the bytes of
the HtoD memcpys of the profiler's CUDA records in the traced window, over
the jobs completed in it."""


def read(run):
    if run.trace is None or run.jobs == 0 or run.trace.h2d_bytes == 0:
        return None
    return run.trace.h2d_bytes / 1e9 / run.jobs
