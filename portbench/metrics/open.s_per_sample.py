"""open.s_per_sample: the program's own per-sample set-up (the span
``open``: the engine with its device reference, the decoder, the sample's
state), the mean over the window's samples.  None where the program
records no spans."""


def read(run):
    done = [m for _, m in run.completed if getattr(m, "spans", None)]
    if not done:
        return None
    return sum(m.spans.get("open", 0.0) for m in done) / len(done)
