"""device_peak_GB: the most device memory the program held at once in the
window (torch.cuda.max_memory_allocated, its peak reset after set-up), in
1e9 bytes."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
