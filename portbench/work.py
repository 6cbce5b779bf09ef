"""The work a kernel must do for the benchmark's inputs, worked out from the
inputs alone (the map and the decoded records), never from the program's
own structures, so that the count stays the same whatever kernel does the
work.  Each function returns (bytes, operations) as lower bounds: every
input byte read once, every output byte written once, no padding and no
re-reads.  ``roofline_s`` turns them into the least time the card could
take, by the table of peaks (peaks.json).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks(device_name: str) -> dict:
    """The card's published peaks (peaks.json), by its name; raises for a
    card the table does not hold."""
    with open(_PEAKS) as fh:
        table = json.load(fh)
    for key, row in table.items():
        if key in device_name:
            return row
    raise KeyError(f"peaks.json has no entry for {device_name!r}")


def roofline_s(nbytes: float, ops: float, pk: dict) -> float:
    """The larger of bytes over peak bandwidth and operations over peak rate."""
    return max(nbytes / pk["bytes_per_s"], ops / pk["ops_per_s"])


def map_tables_bytes(ref) -> int:
    """The map's tables that counting consults, once: each measured span's
    start, end (int32) and MBS offset (int64), each boundary point (int32),
    each ROI's chromosome, start and end (int32), and the per-chromosome
    segments (int32)."""
    n_chroms = len(ref.chroms)
    return (16 * ref.uspan_start.size + 4 * ref.point_coord.size
            + 12 * len(ref.roi_names) + 4 * 3 * (n_chroms + 1))


def count_step(ref, n_blocks: int, n_frags: int) -> tuple:
    """One sample's counting: each aligned block's chromosome, start, end
    and strand (4 x int32) and each fragment's chromosome, reference,
    start, end and strand (5 x int32) read once, and the map's tables once
    a sample.  Operations, as the port's kernel notes count them: per block,
    two searches of the span table and two of the point table at ~4
    operations a step, plus 16; per fragment ~6 per ROI row, plus 8."""
    nbytes = 16 * n_blocks + 20 * n_frags + map_tables_bytes(ref)
    steps = 2 * math.log2(max(ref.uspan_start.size, 2)) + 2 * math.log2(max(ref.point_coord.size, 2))
    ops = n_blocks * (4 * steps + 16) + n_frags * (6 * len(ref.roi_names) + 8)
    return nbytes, ops


def intron_stats(ref) -> tuple:
    """One sample's per-intron statistics: both strands' depth (int32) at
    every measured base read once (the measured bases are the union of
    every intron's included bases, so each is read once however many
    introns include it), and per intron two rows of seven 4-byte statistics
    (coverage and depth sums, three percentiles, two edge windows; the
    non-directional one and the directional one) written once.  Operations:
    ~12 integer operations per included base of each intron."""
    nbytes = 2 * 4 * ref.mbs_size + 2 * 7 * 4 * ref.n_introns
    ops = 12 * int(np.asarray(ref.run_len, np.int64).sum())
    return nbytes, ops
