"""sample_s_p90: the 90th percentile of the samples' walls, each from the
call to its return (the host's clock), over every sample of the window.
Only for a traffic of one sample a call, and only with ten samples or
more, so that the percentile has one sample or more beyond it."""

import statistics


def read(run):
    if int(run.spec.traffic["samples_per_call"]) != 1:
        return None
    walls = [c.end - c.start for c in run.calls if c.metrics is not None]
    if len(walls) < 10:
        return None
    return statistics.quantiles(walls, n=10, method="inclusive")[8]
