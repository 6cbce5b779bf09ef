"""batch.stream.s_per_Mrec: the count stream of batch-mode calls (the span
``stream``: every sample's decoder and the one consumer, from the first
feeder's start to the end-of-stream synchronize), summed over the window's
calls, per million BAM records of the calls' samples.  The cohort's
counting pace with its decoders sharing the host; comparable with one
sample's decode.s_per_Mrec under run_bam.  Each call is read once, through
its first sample: every sample carries the call's spans.  None where the
program records no ``batch`` span."""


def read(run):
    calls = [c for c in run.calls
             if c.metrics and "batch" in getattr(c.metrics[0], "spans", {})]
    records = sum(run.inputs[i].records for c in calls for i in c.inputs)
    if not records:
        return None
    return sum(c.metrics[0].spans["stream"] for c in calls) / records * 1e6
