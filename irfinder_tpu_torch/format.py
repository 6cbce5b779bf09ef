"""Byte-exact output table writers.

The reference wrote fixed-column tab-separated tables from C++ iostreams
(SURVEY.md §2 row 16 [R]); bit-identity of IRFinder-IR-{nondir,dir}.txt is a
graded metric (BASELINE.json:2,5), so every numeric format lives here as one
named function to be pinned against golden files the first time they are
available (SURVEY.md §0 verification protocol, §7.3 item 2).
"""

from __future__ import annotations

from typing import IO, Sequence

import numpy as np

from . import semantics as S
from .refio.compile import CompiledRef, STRAND_CHAR


def fmt_float(v: float) -> str:
    """Float column format for IR tables — C printf %g equivalent.
    [R:verify vs goldens]"""
    return f"{v:g}"


def _native_render(cols) -> str | None:
    """Bulk-render a column spec through native/tabfmt (one GIL-released C
    call); None when the native library is unavailable (callers fall back
    to the per-line Python loop, which remains the formatting spec)."""
    try:
        from .native import tabfmt

        return tabfmt.format_table(cols).decode("ascii")
    except (RuntimeError, UnicodeDecodeError):
        return None


def write_ir_table(out: IO[str], rows, header: bool = True) -> None:
    """IRFinder-IR-nondir.txt / IRFinder-IR-dir.txt (SURVEY.md §2 column spec,
    20 columns [R:verify order]).  `rows`: an iterable of IntronRow, or a
    finalize.IRTable (column-oriented; rendered in one native call)."""
    if header:
        out.write("\t".join(S.IR_TABLE_COLUMNS) + "\n")
    from .finalize import IRTable

    if isinstance(rows, IRTable):
        data = _native_render(rows.native_columns())
        if data is not None:
            out.write(data)
            return
        rows = rows.rows()
    f = fmt_float
    for r in rows:
        out.write(
            "\t".join(
                (
                    r.chrom,
                    str(r.start),
                    str(r.end),
                    r.name,
                    "0",
                    r.strand,
                    f(r.coverage),
                    f(r.intron_depth),
                    str(r.p25),
                    str(r.p50),
                    str(r.p75),
                    str(r.exon_intron_left),
                    str(r.exon_intron_right),
                    f(r.depth_first50),
                    f(r.depth_last50),
                    str(r.splice_left),
                    str(r.splice_right),
                    str(r.splice_exact),
                    f(r.ir_ratio),
                    r.warning,
                )
            )
            + "\n"
        )


def write_junc_count(out: IO[str], chroms: Sequence[str], junc_tally) -> None:
    """IRFinder-JuncCount.txt: every observed splice junction with
    strand-resolved fragment counts.  junc_tally: a
    junctions.JuncTally (or a {(chrom_id, start, end):
    [fwd, rev]} dict — sparse dynamic keys stay host-side; SURVEY.md §2
    row 10).  Sorted by (chrom, start, end).
    Columns [R:verify]: Chr Start End Fwd Rev Total."""
    from .junctions import coerce_tally

    out.write("Chr\tStart\tEnd\tFwd\tRev\tTotal\n")
    keys, vals = coerce_tally(junc_tally).merged()  # already (c,s,e)-sorted
    data = _native_render(
        [
            ("s", keys[:, 0], list(chroms)),
            ("i", keys[:, 1]),
            ("i", keys[:, 2]),
            ("i", vals[:, 0]),
            ("i", vals[:, 1]),
            ("i", vals[:, 0] + vals[:, 1]),
        ]
    ) if len(keys) else ""
    if data is not None:
        out.write(data)
        return
    out.writelines(
        f"{chroms[c]}\t{s}\t{e}\t{fwd}\t{rev}\t{fwd + rev}\n"
        for (c, s, e), (fwd, rev) in zip(keys.tolist(), vals.tolist())
    )


def write_spans_point(out: IO[str], ref: CompiledRef, span_hits: np.ndarray) -> None:
    """IRFinder-SpansPoint.txt: per unique intron boundary point, reads whose
    aligned block spans it with >= SPANS_OVERHANG on both sides.
    Columns [R:verify]: Chr Coord Fwd Rev Total."""
    out.write("Chr\tCoord\tFwd\tRev\tTotal\n")
    n = int(ref.point_coord.size)
    cs_arr = np.searchsorted(ref.point_seg, np.arange(n), side="right") - 1
    fwd_arr = np.asarray(span_hits[0][:n])
    rev_arr = np.asarray(span_hits[1][:n])
    data = _native_render(
        [
            ("s", cs_arr, list(ref.chroms)),
            ("i", ref.point_coord),
            ("i", fwd_arr),
            ("i", rev_arr),
            ("i", fwd_arr.astype(np.int64) + rev_arr),
        ]
    ) if n else ""
    if data is not None:
        out.write(data)
        return
    cs = cs_arr.tolist()
    coords = ref.point_coord.tolist()
    fwds = fwd_arr.tolist()
    revs = rev_arr.tolist()
    chroms = ref.chroms
    out.writelines(
        f"{chroms[c]}\t{co}\t{f}\t{r}\t{f + r}\n"
        for c, co, f, r in zip(cs, coords, fwds, revs)
    )


def write_roi(out: IO[str], ref: CompiledRef, roi_cnt: np.ndarray) -> None:
    """IRFinder-ROI.txt: fragment counts per named region of interest.
    Columns [R:verify]: Name Chr Start End Strand Fwd Rev Total."""
    out.write("Name\tChr\tStart\tEnd\tStrand\tFwd\tRev\tTotal\n")
    n = len(ref.roi_names)
    cs = (np.searchsorted(ref.roi_seg, np.arange(n), side="right") - 1).tolist()
    fwds = np.asarray(roi_cnt[0, :n]).tolist()
    revs = np.asarray(roi_cnt[1, :n]).tolist()
    out.writelines(
        f"{ref.roi_names[r]}\t{ref.chroms[cs[r]]}\t{s}\t{e}\t{STRAND_CHAR[st]}\t"
        f"{f}\t{v}\t{f + v}\n"
        for r, (s, e, st, f, v) in enumerate(
            zip(
                ref.roi_start.tolist(), ref.roi_end.tolist(),
                ref.roi_strand.tolist(), fwds, revs,
            )
        )
    )


def write_chr_coverage(out: IO[str], ref_names: Sequence[str], chr_frag: np.ndarray) -> None:
    """IRFinder-ChrCoverage.txt: fragments per BAM reference sequence.
    Columns [R:verify]: Chr Fragments."""
    out.write("Chr\tFragments\n")
    for i, nm in enumerate(ref_names):
        out.write(f"{nm}\t{int(chr_frag[i])}\n")
