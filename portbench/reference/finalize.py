"""The reference's finalize, written plainly, one intron at a time, from
IRFinder's rules as semantics.py states them: each intron's depth
statistics, its row of the IR table (the join of the statistics with the
splice and span counters), IRratio and the warning, and the library's
directionality call.

* An intron's included bases are its runs of measured bases, in genomic
  order; its depths are those bases' entries of the depth counter.
* Coverage is the share of its bases with a depth above 0, the mean depth
  their mean; p25, p50 and p75 are nearest-rank percentiles of the sorted
  depths (index ceil(q n) - 1, clamped to [0, n - 1]); the edge windows
  are the mean depth of the first and of the last min(EDGE_DEPTH_WINDOW,
  n) bases.  An intron without bases reads 0 throughout.
* SpliceLeft, SpliceRight and SpliceExact are the junction counts at the
  intron's unique start, end and (start, end) pair, ExonToIntronReads*
  the span hits at its two boundary points.
* Non-directional rows sum both fragment strands.  Directional rows keep
  the strand that the library maps to the intron's strand (the opposite
  one when the library is flipped); an intron of unknown strand keeps both.
* IRratio = depth / (depth + max(SpliceLeft, SpliceRight)), 0 without
  signal; the warning is the first of LowCover, LowSplicing, MinorIsoform
  and NonUniformIntronCover whose rule holds.

``real`` is the floating type of the statistics (coverage, mean depth,
the edge windows, IRratio): float64 as the configuration states; the
control computes them in float32, the nearest precision below it, and
must fail the comparison.
"""

from __future__ import annotations

import math

import numpy as np

from ..frozen import semantics as S
from ..frozen.compile import CompiledRef

#: percentiles of the IR table
QUANTILES = (0.25, 0.50, 0.75)


def rank(q: float, n: int) -> int:
    """Nearest-rank index of quantile ``q`` into ``n`` sorted values."""
    return min(n - 1, max(0, math.ceil(q * n) - 1))


def intron_depths(runs: list, dsum: np.ndarray) -> np.ndarray:
    """The depths of an intron's included bases, in genomic order, from its
    runs [(first measured base, length), ...]."""
    parts = [dsum[a:a + n] for a, n in runs]
    return np.concatenate(parts) if len(parts) > 1 else (parts[0] if parts else dsum[:0])


def depth_stats(d: np.ndarray, real) -> tuple:
    """(coverage, mean, p25, p50, p75, first window, last window) of one
    intron's depths ``d``."""
    n = int(d.size)
    if n == 0:
        z = real(0)
        return z, z, 0, 0, 0, z, z
    s = np.sort(d)
    p25, p50, p75 = (int(s[rank(q, n)]) for q in QUANTILES)
    w = min(S.EDGE_DEPTH_WINDOW, n)
    total = int(d.sum(dtype=np.int64))
    return (real(int(np.count_nonzero(d))) / real(n), real(total) / real(n), p25, p50, p75,
            real(int(d[:w].sum(dtype=np.int64))) / real(w),
            real(int(d[n - w:].sum(dtype=np.int64))) / real(w))


def warning(mean, p25: int, p75: int, sl: int, sr: int, sx: int) -> str:
    smax = max(sl, sr)
    if mean < S.WARN_LOW_COVER_DEPTH:
        return "LowCover"
    if smax < S.WARN_LOW_SPLICING_COUNT:
        return "LowSplicing"
    if sx * S.WARN_MINOR_ISOFORM_MULT < smax:
        return "MinorIsoform"
    if p75 - p25 > S.WARN_NONUNIFORM_IQR_VS_MEAN * mean:
        return "NonUniformIntronCover"
    return S.WARNING_NONE


def ir_rows(ref: CompiledRef, depth: np.ndarray, start_cnt: np.ndarray, end_cnt: np.ndarray,
            exact_cnt: np.ndarray, span_hits: np.ndarray, directional: bool = False,
            flip: bool = False, real=np.float64, cache: dict | None = None) -> list:
    """One row per intron, in the map's order: (coverage, mean, p25, p50,
    p75, ExonToIntronReadsLeft, ExonToIntronReadsRight, first window, last
    window, SpliceLeft, SpliceRight, SpliceExact, IRratio, warning).
    ``depth`` and the counters have a leading strand axis (0 forward, 1
    reverse).  ``cache`` shares each (strand selection, intron)'s
    statistics between the two tables of one sample."""
    cache = {} if cache is None else cache
    both = depth[0] + depth[1]
    off, first, length = (ref.intron_run_off.tolist(), ref.run_mbs_start.tolist(),
                          ref.run_len.tolist())
    strand = ref.intron_strand.tolist()
    idx = [ref.intron_bstart_idx.tolist(), ref.intron_bend_idx.tolist(),
           ref.intron_pair_idx.tolist(), ref.intron_pstart_idx.tolist(),
           ref.intron_pend_idx.tolist()]
    tables = [[a.tolist() for a in (np.asarray(t[0], np.int64), np.asarray(t[1], np.int64))]
              for t in (start_cnt, end_cnt, exact_cnt, span_hits, span_hits)]
    rows = []
    for i in range(ref.n_introns):
        st = strand[i]
        if not directional or st >= 2:
            v = 2
        else:
            v = 1 - st if flip else st
        if (v, i) not in cache:
            runs = [(first[r], length[r]) for r in range(off[i], off[i + 1])]
            cache[v, i] = depth_stats(intron_depths(runs, both if v == 2 else depth[v]), real)
        cov, mean, p25, p50, p75, fw, lw = cache[v, i]
        sl, sr, sx, eil, eir = (t[0][j[i]] + t[1][j[i]] if v == 2 else t[v][j[i]]
                                for t, j in zip(tables, idx))
        denom = mean + real(max(sl, sr))
        ratio = mean / denom if denom > 0 else real(0)
        rows.append((cov, mean, p25, p50, p75, eil, eir, fw, lw, sl, sr, sx, ratio,
                     warning(mean, p25, p75, sl, sr, sx)))
    return rows


def detect_directionality(ref: CompiledRef, exact_cnt: np.ndarray) -> tuple:
    """(stranded, flip, concordance, informative reads): the library's
    strandedness from the exact-junction counts of the unique junctions
    whose introns all lie on one known strand.  ``flip``: forward
    fragments map to the annotation's '-' strand."""
    pair_strand: dict = {}
    for i in range(ref.n_introns):
        k, st = int(ref.intron_pair_idx[i]), int(ref.intron_strand[i])
        pair_strand[k] = st if pair_strand.get(k, st) == st else 2
    same = opposite = 0
    for k, st in pair_strand.items():
        if st in (0, 1):
            same += int(exact_cnt[st, k])
            opposite += int(exact_cnt[1 - st, k])
    total = same + opposite
    if total < S.DIR_MIN_INFORMATIVE:
        return False, False, 0.0, total
    frac = max(same, opposite) / total
    return frac >= S.DIR_CONCORDANCE_THRESHOLD, opposite > same, frac, total
