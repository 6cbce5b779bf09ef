"""stream.wait_share: the share of the count stream (the span ``stream``)
that its consumer spent waiting for a decoded batch (``stream.wait``), in
percent, over the window's samples.  None where the program records no
spans."""


def read(run):
    done = [m for _, m in run.completed if getattr(m, "spans", None)]
    stream = sum(m.spans.get("stream", 0.0) for m in done)
    if not stream:
        return None
    return 100.0 * sum(m.spans.get("stream.wait", 0.0) for m in done) / stream
