"""Run-level QC: the WARNINGS file.

The reference's bash layer derived a WARNINGS file from ROI and coverage
statistics after the C++ counter finished (SURVEY.md §3.2, §5.5 [R]): high
rRNA/mitochondrial load, low fragment or junction yield, strandedness
anomalies.  Thresholds are centralized here for golden pinning [R:verify].
"""

from __future__ import annotations

from typing import IO


from .refio.compile import CompiledRef

#: Fraction of fragments in rRNA-named ROIs above which the library is
#: flagged (poor rRNA depletion).
WARN_RRNA_FRACTION = 0.20  # [R:verify]
#: Fraction of fragments on mitochondrial ROIs/chromosome above which flagged.
WARN_MT_FRACTION = 0.30  # [R:verify]
#: Minimum admitted fragments for a usable sample.
WARN_MIN_FRAGMENTS = 100_000  # [R:verify]
#: Minimum total exact-junction reads for reliable splice quantification.
WARN_MIN_JUNCTIONS = 10_000  # [R:verify]
#: Directionality concordance band considered anomalous (neither clearly
#: stranded nor clearly unstranded).
WARN_DIR_AMBIGUOUS_LOW = 0.6  # [R:verify]


def qc_warnings(
    ref: CompiledRef,
    fc: dict,
    metrics,
) -> list:
    """List of human-readable warning lines (empty = clean run)."""
    warns = []
    n_frags = int(fc["n_frags"])
    if n_frags < WARN_MIN_FRAGMENTS:
        warns.append(
            f"LowFragmentCount: {n_frags} admitted fragments "
            f"(< {WARN_MIN_FRAGMENTS}); results may be unstable"
        )
    if n_frags > 0 and len(ref.roi_names):
        roi_tot = fc["roi_cnt"].sum(axis=0)
        rna = sum(
            int(roi_tot[r])
            for r, nm in enumerate(ref.roi_names)
            if "rrna" in nm.lower()
        )
        mt = sum(
            int(roi_tot[r])
            for r, nm in enumerate(ref.roi_names)
            if nm.lower().startswith(("mt", "chrm")) or "mito" in nm.lower()
        )
        if rna / n_frags > WARN_RRNA_FRACTION:
            warns.append(
                f"HighRRNA: {rna / n_frags:.1%} of fragments in rRNA regions "
                f"(> {WARN_RRNA_FRACTION:.0%}); rRNA depletion may have failed"
            )
        if mt / n_frags > WARN_MT_FRACTION:
            warns.append(
                f"HighMitochondrial: {mt / n_frags:.1%} of fragments "
                f"mitochondrial (> {WARN_MT_FRACTION:.0%})"
            )
    n_junc = int(fc["exact_cnt"].sum())
    if n_junc < WARN_MIN_JUNCTIONS:
        warns.append(
            f"LowJunctionCount: {n_junc} annotated exact-junction reads "
            f"(< {WARN_MIN_JUNCTIONS}); splicing denominator unreliable"
        )
    frac = getattr(metrics, "dir_concordance", 0.0)
    informative = getattr(metrics, "dir_informative", 0)
    stranded = getattr(metrics, "is_stranded", False)
    if informative and not stranded and frac > WARN_DIR_AMBIGUOUS_LOW:
        warns.append(
            f"AmbiguousStrandedness: junction strand concordance {frac:.2f} is "
            "neither clearly stranded nor unstranded; check library protocol"
        )
    return warns


def write_warnings(out: IO[str], warns: list) -> None:
    if not warns:
        out.write("OK\n")
        return
    for w in warns:
        out.write(w + "\n")
