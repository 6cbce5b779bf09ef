"""Pooled small-replicate differential IR between two conditions.

TPU-era replacement for the reference's bin/analysisWithLowReplicates.pl
(SURVEY.md §2 row 19, §3.5 [R]): pool replicate counts per condition, test
each intron's (intronic vs spliced) counts between pools with the
Audic–Claverie exact test (winflat.py), and audit per-replicate
direction consistency.  Operates on written IR tables (any mix of engine or
reference outputs — the tables are the interface, SURVEY.md §1.2) or on
in-memory rows from the multi-sample batch engine (BASELINE.json:10).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

from . import semantics as S
from .winflat import ac_pvalue

#: Minimum pooled intron depth + splice count for a testable intron.
DIFF_MIN_SIGNAL = 4  # [R:verify]


@dataclasses.dataclass
class IRSample:
    """Parsed IR table: parallel lists over introns (order = table order)."""

    key: list  # (chrom, start, end, name, strand)
    intron_depth: list  # float
    splice_max: list  # int
    ir_ratio: list  # float
    warning: list


def read_ir_table(path: str) -> IRSample:
    s = IRSample([], [], [], [], [])
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        col = {name: i for i, name in enumerate(header)}
        for ln in fh:
            f = ln.rstrip("\n").split("\t")
            s.key.append((f[col["Chr"]], int(f[col["Start"]]), int(f[col["End"]]),
                          f[col["Name"]], f[col["Strand"]]))
            depth = float(f[col["IntronDepth"]])
            sl = int(f[col["SpliceLeft"]])
            sr = int(f[col["SpliceRight"]])
            s.intron_depth.append(depth)
            s.splice_max.append(S.splice_max(sl, sr))
            s.ir_ratio.append(float(f[col["IRratio"]]))
            s.warning.append(f[col["Warnings"]])
    return s


def _load_condition(dirs: Sequence[str], table: str) -> list:
    return [read_ir_table(os.path.join(d, table)) for d in dirs]


DIFF_COLUMNS = (
    "Chr", "Start", "End", "Name", "Strand",
    "A-IntronDepth", "A-SpliceMax", "A-IRratio",
    "B-IntronDepth", "B-SpliceMax", "B-IRratio",
    "IRratio-diff", "p-value", "Consistency",
)


def differential_rows(
    samples_a: Sequence[IRSample],
    samples_b: Sequence[IRSample],
    min_cov: float | None = None,
) -> list:
    """One row per intron: pooled counts, pooled IRratios, A-C p-value on
    (intronic vs spliced) pooled counts, and the replicate-direction audit
    ('consistent' iff every A-vs-pooled-B replicate pair moves the same way
    as the pooled comparison [R:verify audit rule])."""
    keys = samples_a[0].key
    for s in samples_a + samples_b:
        if s.key != keys:
            raise ValueError("IR tables do not share an intron row set")
    pre = []
    for i, key in enumerate(keys):
        da = sum(s.intron_depth[i] for s in samples_a)
        db = sum(s.intron_depth[i] for s in samples_b)
        ja = sum(s.splice_max[i] for s in samples_a)
        jb = sum(s.splice_max[i] for s in samples_b)
        if min_cov is not None and (da < min_cov and db < min_cov):
            continue
        if da + ja < DIFF_MIN_SIGNAL or db + jb < DIFF_MIN_SIGNAL:
            continue
        ra = da / (da + ja) if da + ja > 0 else 0.0
        rb = db / (db + jb) if db + jb > 0 else 0.0
        direction = rb - ra
        consistent = True
        for sa in samples_a:
            for sb in samples_b:
                d = sb.ir_ratio[i] - sa.ir_ratio[i]
                if direction != 0 and d * direction < 0:
                    consistent = False
        pre.append((key, da, ja, ra, db, jb, rb, direction, consistent, i))

    # A-C test: intronic count in A vs B, normalized by total (intronic +
    # spliced) abundance as the library-size proxy (pooled winflat call of the
    # Perl script [R:verify normalization]).  One batch call through the
    # native winflat when built; pure-Python fallback otherwise.
    xs = [int(round(r[1])) for r in pre]
    ys = [int(round(r[4])) for r in pre]
    nxs = [max(1.0, r[1] + r[2]) for r in pre]
    nys = [max(1.0, r[4] + r[5]) for r in pre]
    try:
        from .native.winflat_native import pvalues

        ps = pvalues(xs, ys, nxs, nys)
    except Exception:
        ps = [ac_pvalue(x, y, nx, ny) for x, y, nx, ny in zip(xs, ys, nxs, nys)]
    return [
        (key, da, ja, ra, db, jb, rb, direction, float(p), consistent)
        for (key, da, ja, ra, db, jb, rb, direction, consistent, _i), p in zip(pre, ps)
    ]


def write_differential(out_path: str, rows: list) -> None:
    with open(out_path, "w") as fh:
        fh.write("\t".join(DIFF_COLUMNS) + "\n")
        for (key, da, ja, ra, db, jb, rb, diff, p, cons) in rows:
            chrom, start, end, name, strand = key
            fh.write(
                f"{chrom}\t{start}\t{end}\t{name}\t{strand}\t"
                f"{da:g}\t{ja}\t{ra:g}\t{db:g}\t{jb}\t{rb:g}\t"
                f"{diff:g}\t{p:g}\t{'consistent' if cons else 'inconsistent'}\n"
            )


def run_differential(
    cond_a: Sequence[str],
    cond_b: Sequence[str],
    out_path: str,
    table: str = "IRFinder-IR-nondir.txt",
    min_cov: float | None = None,
) -> int:
    rows = differential_rows(
        _load_condition(cond_a, table), _load_condition(cond_b, table), min_cov=min_cov
    )
    write_differential(out_path, rows)
    print(f"Diff: {len(rows)} testable introns -> {out_path}")
    return 0
