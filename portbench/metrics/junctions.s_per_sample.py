"""junctions.s_per_sample: the program's own junction time (the spans
``junctions.tally``, each batch's gaps packed on the consumer,
``junctions.merge``, the tally's drain, and ``junctions.join``, the join
against the map), the mean over the window's samples.  None where the
program records no spans."""

SPANS = ("junctions.tally", "junctions.merge", "junctions.join")


def read(run):
    done = [m for _, m in run.completed if getattr(m, "spans", None)]
    if not done:
        return None
    return sum(sum(m.spans.get(k, 0.0) for k in SPANS) for m in done) / len(done)
