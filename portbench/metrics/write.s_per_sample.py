"""write.s_per_sample: the program's own table-write time (the spans
``write.<table>`` of RunMetrics.spans: the six tables, WARNINGS and
metrics.json, each rendered and written), the mean over the window's
samples.  None where the program records no spans."""


def read(run):
    done = [m for _, m in run.completed if getattr(m, "spans", None)]
    if not done:
        return None
    return sum(sum(v for k, v in m.spans.items() if k.startswith("write.")) for m in done) / len(done)
