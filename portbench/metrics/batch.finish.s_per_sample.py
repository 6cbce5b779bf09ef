"""batch.finish.s_per_sample: the seconds of batch-mode calls after their
stream drained (the span ``batch.finish``: the finalize of every sample,
then every sample's tables, in turn), summed over the window's calls, over
the samples those calls completed (each call's ``batch_samples``).
Comparable with one sample's finalize.s_per_sample plus write.s_per_sample
under run_bam.  Each call is read once, through its first sample: every
sample carries the call's spans.  None where the program records no
``batch`` span."""


def read(run):
    calls = [c.metrics for c in run.calls
             if c.metrics and "batch" in getattr(c.metrics[0], "spans", {})]
    if not calls:
        return None
    return sum(ms[0].spans["batch.finish"] for ms in calls) / sum(ms[0].batch_samples for ms in calls)
