"""Audic–Claverie exact test — the math of the reference's winflat micro-tool
(SURVEY.md §2 row 18, historical src/winflat/winflat.c [R]; Audic & Claverie,
Genome Res 1997).

Given count x in a library of (relative) size nx and count y in a library of
size ny, the probability of observing y conditioned on x under the null of
equal underlying rates is

    p(y | x) = r^y * (x+y)! / ( x! * y! * (1+r)^(x+y+1) ),   r = ny/nx

The test p-values are the cumulative tails over y.  Computed in log-space
with lgamma for arbitrary counts; this pure-Python module is the conformance
reference for the native C++ implementation (csrc/host/winflat.cpp), which the
batch differential path uses for speed.
"""

from __future__ import annotations

import math


def log_p_y_given_x(x: int, y: int, r: float) -> float:
    """log p(y|x) as above."""
    return (
        y * math.log(r)
        + math.lgamma(x + y + 1)
        - math.lgamma(x + 1)
        - math.lgamma(y + 1)
        - (x + y + 1) * math.log1p(r)
    )


def tail_p(x: int, y: int, nx: float = 1.0, ny: float = 1.0):
    """Returns (p_le, p_ge): probability of observing <= y (>= y) in library
    B given x in library A.  Exact cumulative sums (the smaller tail is summed
    directly; the other is 1 - sum + point mass)."""
    r = ny / nx
    # sum the lower tail 0..y directly (log-space accumulation)
    acc = 0.0
    for k in range(0, y + 1):
        acc += math.exp(log_p_y_given_x(x, k, r))
    p_le = min(1.0, acc)
    point = math.exp(log_p_y_given_x(x, y, r))
    p_ge = min(1.0, 1.0 - p_le + point)
    return p_le, p_ge


def ac_pvalue(x: int, y: int, nx: float = 1.0, ny: float = 1.0) -> float:
    """Two-sided p-value: twice the smaller tail, capped at 1 (the
    convention of the reference's low-replicate script [R:verify])."""
    p_le, p_ge = tail_p(x, y, nx, ny)
    return min(1.0, 2.0 * min(p_le, p_ge))
