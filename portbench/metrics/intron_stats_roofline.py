"""intron_stats_roofline: the least time the card could take for the
per-intron statistics of the window's samples (work.intron_stats, from the
map), as a share of the device time of the kernels named intron_stats in
the traced window."""

from portbench import work


def read(run):
    if run.trace is None:
        return None
    kernel_s = sum(s for name, s in run.trace.device_time.items() if "intron_stats" in name)
    if not kernel_s or not run.completed:
        return None
    b, o = work.intron_stats(run.ref)
    n = len(run.completed)
    return 100.0 * work.roofline_s(n * b, n * o, work.peaks(run.device_name)) / kernel_s
