"""device_mem_peak_gb: the most device memory the program held at once in
the window, in GB (1e9 bytes): the CUDA caching allocator's peak of
allocated bytes (torch.cuda.max_memory_allocated), reset when the warm-up
ends.  GraphMP keeps the vertex arrays on the device and streams the edges
through it, so this is what a job of the cell needs of the card.  Nothing
on the CPU."""


def read(run):
    if run.memory_peak_bytes <= 0:
        return None
    return run.memory_peak_bytes / 1e9
