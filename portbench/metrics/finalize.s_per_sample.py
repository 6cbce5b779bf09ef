"""finalize.s_per_sample: the program's own finalize time
(RunMetrics.finalize_s: device cumsums, junction join, device statistics,
pulls, host finish and the IR tables' columns; with its syncs), the mean
over the window's samples."""


def read(run):
    done = run.completed
    if not done:
        return None
    return sum(m.finalize_s for _, m in done) / len(done)
