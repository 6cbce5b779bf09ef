"""The reference's table texts: the per-line Python formats of
irfinder_tpu_torch/format.py (commit fa27846), the port's byte-exact
specification of every IRFinder table, rendered without the port's native
renderer.

The integer tables (JuncCount, SpansPoint) can run to millions of lines (a
long-read sample has ~14M distinct junctions), so they are rendered by
``render_int_table``: the same text as the per-line f-string, built with
NumPy digit arithmetic; tests/test_portbench_reference.py holds the two to
each other.
"""

from __future__ import annotations

import numpy as np

from ..frozen import semantics as S
from ..frozen.compile import STRAND_CHAR


def fmt_float(v) -> str:
    """Float column format for IR tables — C printf %g."""
    return f"{float(v):g}"


def ir_table(ref, rows: list) -> str:
    """IRFinder-IR-nondir.txt / IRFinder-IR-dir.txt from the rows of
    finalize.ir_rows."""
    f = fmt_float
    chroms = ref.chroms
    lines = ["\t".join(S.IR_TABLE_COLUMNS) + "\n"]
    for c, s, e, name, st, (cov, mean, p25, p50, p75, eil, eir, fw, lw, sl, sr, sx, r, w) in zip(
            ref.intron_chrom.tolist(), ref.intron_start.tolist(), ref.intron_end.tolist(),
            ref.intron_names, ref.intron_strand.tolist(), rows):
        lines.append(
            f"{chroms[c]}\t{s}\t{e}\t{name}\t0\t{STRAND_CHAR[st]}\t{f(cov)}\t{f(mean)}\t"
            f"{p25}\t{p50}\t{p75}\t{eil}\t{eir}\t{f(fw)}\t{f(lw)}\t{sl}\t{sr}\t{sx}\t"
            f"{f(r)}\t{w}\n"
        )
    return "".join(lines)


def _digit_matrix(v: np.ndarray) -> np.ndarray:
    """(n, width) ASCII digits of each non-negative integer, right-aligned,
    0 (no character) in place of leading zeros."""
    width = len(str(int(v.max()))) if v.size else 1
    out = np.empty((v.size, width), np.uint8)
    t = v.astype(np.uint32 if width < 10 else np.uint64)
    for k in range(width - 1, -1, -1):
        t, r = np.divmod(t, 10)
        out[:, k] = r
    out += ord("0")
    digits = np.ones(v.size, np.int64)
    for k in range(1, width):
        digits += v >= 10 ** k
    out[np.arange(width)[None, :] < (width - digits)[:, None]] = 0
    return out


def render_int_table(header: str, labels: list, label_idx: np.ndarray, cols: list) -> str:
    """``header`` then one line per row: ``labels[label_idx[i]]`` and each
    column of ``cols`` (non-negative integers), tab-separated.  Each line is
    laid out in a row of a byte matrix, 0 where it has no character, and
    the matrix read row by row without the 0s."""
    n = int(label_idx.size)
    if n == 0:
        return header
    cols = [np.asarray(c, np.int64) for c in cols]
    if any((c < 0).any() for c in cols):
        raise ValueError("render_int_table: negative value")
    lab = [s.encode() for s in labels]
    table = np.zeros((len(lab), max(len(s) for s in lab)), np.uint8)
    for i, s in enumerate(lab):
        table[i, : len(s)] = np.frombuffer(s, np.uint8)
    parts = [table[label_idx]]
    for c in cols:
        parts.append(np.full((n, 1), ord("\t"), np.uint8))
        parts.append(_digit_matrix(c))
    parts.append(np.full((n, 1), ord("\n"), np.uint8))
    m = np.concatenate(parts, axis=1)
    return header + m[m != 0].tobytes().decode("ascii")


def junc_count(chroms: list, keys: np.ndarray, vals: np.ndarray) -> str:
    """IRFinder-JuncCount.txt: Chr Start End Fwd Rev Total, sorted by
    (chrom, start, end)."""
    return render_int_table(
        "Chr\tStart\tEnd\tFwd\tRev\tTotal\n", list(chroms), keys[:, 0],
        [keys[:, 1], keys[:, 2], vals[:, 0], vals[:, 1], vals[:, 0] + vals[:, 1]],
    )


def spans_point(ref, span_hits: np.ndarray) -> str:
    """IRFinder-SpansPoint.txt: Chr Coord Fwd Rev Total."""
    n = int(ref.point_coord.size)
    cs = np.searchsorted(ref.point_seg, np.arange(n), side="right") - 1
    fwd, rev = span_hits[0][:n].astype(np.int64), span_hits[1][:n].astype(np.int64)
    return render_int_table(
        "Chr\tCoord\tFwd\tRev\tTotal\n", list(ref.chroms), cs,
        [ref.point_coord, fwd, rev, fwd + rev],
    )


def roi(ref, roi_cnt: np.ndarray) -> str:
    """IRFinder-ROI.txt: Name Chr Start End Strand Fwd Rev Total."""
    n = len(ref.roi_names)
    cs = (np.searchsorted(ref.roi_seg, np.arange(n), side="right") - 1).tolist()
    fwds = np.asarray(roi_cnt[0, :n]).tolist()
    revs = np.asarray(roi_cnt[1, :n]).tolist()
    return "Name\tChr\tStart\tEnd\tStrand\tFwd\tRev\tTotal\n" + "".join(
        f"{ref.roi_names[r]}\t{ref.chroms[cs[r]]}\t{s}\t{e}\t{STRAND_CHAR[st]}\t"
        f"{f}\t{v}\t{f + v}\n"
        for r, (s, e, st, f, v) in enumerate(
            zip(ref.roi_start.tolist(), ref.roi_end.tolist(), ref.roi_strand.tolist(), fwds, revs)
        )
    )


def chr_coverage(ref_names: list, chr_frag: np.ndarray) -> str:
    """IRFinder-ChrCoverage.txt: Chr Fragments, per BAM reference."""
    return "Chr\tFragments\n" + "".join(
        f"{nm}\t{int(chr_frag[i])}\n" for i, nm in enumerate(ref_names)
    )
