"""decode.pool_wait_share: the share of the program's decode time
(RunMetrics.decode_s) in which the native decoder's ordering thread waited
on its worker pool for an inflated block or a parsed chunk
(RunMetrics.decode_pool_wait_s), in percent, over the window's samples.
High: the pool sets the decoder's pace; low: the ordering thread (framing,
pairing, emission) does.  None where the program has no such counter or
no decode time."""


def read(run):
    done = [m for _, m in run.completed]
    if not done or not all(hasattr(m, "decode_pool_wait_s") for m in done):
        return None
    decode = sum(m.decode_s for m in done)
    if not decode:
        return None
    return 100.0 * sum(m.decode_pool_wait_s for m in done) / decode
