"""peak_device_GiB.count: the most device memory the allocator held on
the busiest card during the window (``torch.cuda.max_memory_allocated``)."""


def read(run):
    if run.kind != "count" or not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 30
