"""batch.finish_share: the share of a batch-mode call (the span ``batch``,
run_multi_bam from before its engine and decoders open to its return)
spent after its stream drained (``batch.finish``: the finalize of every
sample, then every sample's tables, in turn), in percent, over the window's
calls.  Each call is read once, through its first sample: every sample
carries the call's spans.  None where the program records no ``batch``
span (one sample a call, or a program without it)."""


def read(run):
    calls = [c.metrics[0].spans for c in run.calls
             if c.metrics and "batch" in getattr(c.metrics[0], "spans", {})]
    batch = sum(s["batch"] for s in calls)
    if not batch:
        return None
    return 100.0 * sum(s["batch.finish"] for s in calls) / batch
