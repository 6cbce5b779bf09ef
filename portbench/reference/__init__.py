"""The benchmark's plain reference: IRFinder's tables for one BAM against a
compiled map, in plain NumPy and Python.

It imports nothing of the program under test.  From the map arrays and
the BAM bytes that the benchmark made, it works out its own decode
(decode.py), counters and junction tally (count.py), per-intron statistics
and join, one intron at a time (finalize.py), and table texts (tables.py:
the port's line formats; qc.py: a frozen copy of the port's WARNINGS
rules).
"""

from __future__ import annotations

import io
import types

import numpy as np

from . import count as C
from . import qc, tables
from .decode import decode
from .finalize import detect_directionality, ir_rows

#: the files a sample writes that the comparison covers, in this order
TABLES = (
    "IRFinder-IR-nondir.txt",
    "IRFinder-IR-dir.txt",
    "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt",
    "IRFinder-ROI.txt",
    "IRFinder-ChrCoverage.txt",
    "WARNINGS",
)


def sample_tables(ref, bam: str, real=np.float64, sizes: dict | None = None) -> dict:
    """{file name: text} of every table in TABLES for the BAM at ``bam``.
    ``real`` is the floating type of the per-intron statistics: float64 as
    the configuration states; float32 is the control.  ``sizes``, when
    given, receives the decoded input's aligned blocks and fragments."""
    d = decode(bam, ref.chroms)
    if sizes is not None:
        sizes.update(blocks=int(d.blk_chrom.size), fragments=int(d.frag_refid.size))
    fc = C.count(ref, d)
    sc, ec, xc = C.junction_counters(ref, fc["junc_keys"], fc["junc_vals"])
    stranded, flip, frac, n_inf = detect_directionality(ref, xc)
    args = (ref, fc["depth"], sc, ec, xc, fc["span_hits"])
    cache: dict = {}
    nondir = ir_rows(*args, real=real, cache=cache)
    dirn = ir_rows(*args, directional=True, flip=flip, real=real, cache=cache)
    run = types.SimpleNamespace(
        is_stranded=bool(stranded), dir_concordance=float(frac), dir_informative=int(n_inf),
    )
    warns = io.StringIO()
    qc.write_warnings(warns, qc.qc_warnings(
        ref, {"n_frags": fc["n_frags"], "roi_cnt": fc["roi_cnt"], "exact_cnt": xc}, run))
    return {
        "IRFinder-IR-nondir.txt": tables.ir_table(ref, nondir),
        "IRFinder-IR-dir.txt": tables.ir_table(ref, dirn),
        "IRFinder-JuncCount.txt": tables.junc_count(ref.chroms, fc["junc_keys"], fc["junc_vals"]),
        "IRFinder-SpansPoint.txt": tables.spans_point(ref, fc["span_hits"]),
        "IRFinder-ROI.txt": tables.roi(ref, fc["roi_cnt"]),
        "IRFinder-ChrCoverage.txt": tables.chr_coverage(d.ref_names, fc["chr_frag"]),
        "WARNINGS": warns.getvalue(),
    }
