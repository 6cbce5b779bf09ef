"""stage.s_per_Mrec: the program's own staging of each batch for the card
(the span ``stage`` on the feeder thread: the batch's columns laid out in
pinned memory and each copy enqueued; one copy a batch under run_bam, one
for each mesh cell under run_bam_mesh), summed over the window's samples,
per million BAM records.  None where the program records no ``stage``
span."""


def read(run):
    done = [(i, m) for i, m in run.completed if "stage" in getattr(m, "spans", {})]
    if not done:
        return None
    records = sum(run.inputs[i].records for i, _ in done)
    return sum(m.spans["stage"] for _, m in done) / records * 1e6
