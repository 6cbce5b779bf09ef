"""Vectorized half-open interval algebra used by the reference compiler.

The reference did this work with bedtools-style awk/perl passes (SURVEY.md §2
row 3 [R]); here it is NumPy over sorted coordinate arrays so the compiler
output is already in the dense tensor form the device consumes
(BASELINE.json:5 "dense sorted coordinate tensors").
"""

from __future__ import annotations

import numpy as np


def merge_intervals(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Merge possibly-overlapping [start, end) intervals into disjoint sorted ones.

    Touching intervals ([0,5) and [5,9)) are merged.  Empty inputs allowed.
    """
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    if starts.size == 0:
        return starts.astype(np.int64), ends.astype(np.int64)
    order = np.lexsort((ends, starts))
    s, e = starts[order], ends[order]
    # running max of ends; a new merged interval begins where start > max(prev ends)
    run_max = np.maximum.accumulate(e)
    new_group = np.ones(s.size, dtype=bool)
    new_group[1:] = s[1:] > run_max[:-1]
    group_id = np.cumsum(new_group) - 1
    n_groups = int(group_id[-1]) + 1
    out_s = s[new_group]  # group start = start of its first interval
    out_e = np.zeros(n_groups, dtype=np.int64)
    np.maximum.at(out_e, group_id, run_max)
    return out_s, out_e


def subtract_from_interval(
    start: int, end: int, ex_starts: np.ndarray, ex_ends: np.ndarray
) -> list[tuple[int, int]]:
    """Return the parts of [start, end) not covered by the disjoint sorted
    exclusion set (ex_starts, ex_ends)."""
    if end <= start:
        return []
    lo = int(np.searchsorted(ex_ends, start, side="right"))
    out = []
    cur = start
    i = lo
    n = ex_starts.size
    while cur < end and i < n and ex_starts[i] < end:
        if ex_starts[i] > cur:
            out.append((cur, int(min(ex_starts[i], end))))
        cur = max(cur, int(ex_ends[i]))
        i += 1
    if cur < end:
        out.append((cur, end))
    return out


def any_overlap(
    starts: np.ndarray,
    ends: np.ndarray,
    q_start: np.ndarray,
    q_end: np.ndarray,
) -> np.ndarray:
    """For each query [q_start, q_end), does it overlap any disjoint sorted
    interval in (starts, ends)?  Vectorized over queries."""
    q_start = np.asarray(q_start, dtype=np.int64)
    q_end = np.asarray(q_end, dtype=np.int64)
    if starts.size == 0:
        return np.zeros(q_start.shape, dtype=bool)
    # candidate: last interval with start < q_end
    idx = np.searchsorted(starts, q_end, side="left") - 1
    valid = idx >= 0
    idx_c = np.clip(idx, 0, starts.size - 1)
    return valid & (ends[idx_c] > q_start)


def min_distance(
    starts: np.ndarray, ends: np.ndarray, q_start: np.ndarray, q_end: np.ndarray
) -> np.ndarray:
    """Distance (bp) from each query to the nearest interval; 0 if overlapping,
    int64 max if the interval set is empty."""
    q_start = np.asarray(q_start, dtype=np.int64)
    q_end = np.asarray(q_end, dtype=np.int64)
    if starts.size == 0:
        return np.full(q_start.shape, np.iinfo(np.int64).max, dtype=np.int64)
    # nearest on the left: last interval with end <= q_start
    li = np.searchsorted(ends, q_start, side="right") - 1
    left_gap = np.where(li >= 0, q_start - ends[np.clip(li, 0, None)], np.iinfo(np.int64).max)
    # nearest on the right: first interval with start >= q_end
    ri = np.searchsorted(starts, q_end, side="left")
    right_gap = np.where(
        ri < starts.size,
        starts[np.clip(ri, None, starts.size - 1)] - q_end,
        np.iinfo(np.int64).max,
    )
    gap = np.minimum(left_gap, right_gap)
    return np.where(any_overlap(starts, ends, q_start, q_end), 0, gap)
