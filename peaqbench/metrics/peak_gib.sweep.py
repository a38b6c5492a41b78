"""Peak device memory over the window, GiB (the allocator's
`max_memory_allocated` after its peak was reset at the window's start)."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2**30
