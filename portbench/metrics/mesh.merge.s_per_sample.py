"""mesh.merge.s_per_sample: the device time of the copies between cards in
the traced window, over the samples the window completed.  Under a mesh
of dp cells on as many cards, the dp merge (parallel/shard.py
merge_stacked) brings each other cell's counters to the first cell's card;
torch.profiler names such a copy ``Memcpy PtoP (Device -> Device)``.  None
where the trace holds no such copy (one card, or no mesh)."""

PREFIX = "Memcpy PtoP"


def read(run):
    if run.trace is None or not run.completed:
        return None
    s = sum(v for name, v in run.trace.device_time.items() if name.startswith(PREFIX))
    return s / len(run.completed) if s else None
