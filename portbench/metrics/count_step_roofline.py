"""count_step_roofline: the least time the card could take for the
counting work of the window's samples (work.count_step, from the decoded
inputs and the map), as a share of the device time of the kernels named
count_step in the traced window."""

from portbench import work


def read(run):
    if run.trace is None:
        return None
    kernel_s = sum(s for name, s in run.trace.device_time.items() if "count_step" in name)
    if not kernel_s or not run.completed:
        return None
    pk = work.peaks(run.device_name)
    nbytes = ops = 0.0
    for i, _ in run.completed:
        b, o = work.count_step(run.ref, *run.decoded[i])
        nbytes, ops = nbytes + b, ops + o
    return 100.0 * work.roofline_s(nbytes, ops, pk) / kernel_s
