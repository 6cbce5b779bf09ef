"""reads_per_s: BAM records of every sample that completed in the window,
over the seconds from the window's start to the end of the last call (the
host's clock).  It covers the whole entry point: decode, count, finalize
and every table written."""


def read(run):
    if not run.completed:
        return None
    records = sum(run.inputs[i].records for i, _ in run.completed)
    return records / (run.t_end - run.t_start)
