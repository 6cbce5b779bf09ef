"""setup_s: from the start of the benchmark's process to the start of the
window: imports, the CUDA context, the map and the BAMs made from the seed,
the warm-up calls (which load the program's kernels, or build them on a
checkout's first run)."""


def read(run):
    return run.setup_s
