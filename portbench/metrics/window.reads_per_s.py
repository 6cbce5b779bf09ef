"""window.reads_per_s: reads_per_s's reading (BAM records of every sample
that completed in the window, over the seconds from the window's start to
the end of the last call, on the host's clock), kept as a per-layer metric
in a cell whose runs spread too widely for an end-to-end bound: there it
is recorded and held to nothing."""


def read(run):
    if not run.completed:
        return None
    records = sum(run.inputs[i].records for i, _ in run.completed)
    return records / (run.t_end - run.t_start)
