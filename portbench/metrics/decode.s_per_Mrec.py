"""decode.s_per_Mrec: the program's own decode time (RunMetrics.decode_s:
each sample's feeder thread blocked in the decoder), summed over the
window's samples, per million BAM records."""


def read(run):
    done = run.completed
    if not done:
        return None
    records = sum(run.inputs[i].records for i, _ in done)
    return sum(m.decode_s for _, m in done) / records * 1e6
