"""Counting semantics for the TPU-native intron-retention engine.

EVERY behavioral constant and formula of the IR quantification lives in this
one module so that each can be *pinned* against reference golden outputs the
first time they become available, per the verification protocol in
SURVEY.md §0.  The reference snapshot contains no source, so each item below
is a reconstruction of IRFinder v1.3.x behavior (historical
src/irfinder/ReadBlockProcessor_CoverageBlocks.cpp, ReadBlockProcessor.cpp,
BAM2blocks.cpp — see SURVEY.md §2 rows 7-16) and carries an ``[R:verify]``
tag where the exact constant could differ from the reference.

This is the port's own copy of irfinder_tpu/semantics.py, constant for
constant, with the same IRTPU_SEMANTICS overrides: the host decoders, the
device step, the finalize and the table writers of the port all read it.
"""

from __future__ import annotations

import dataclasses
import math

# ---------------------------------------------------------------------------
# Coordinate conventions
# ---------------------------------------------------------------------------
# All internal coordinates are 0-based half-open [start, end), BED-style.
# GTF input (1-based inclusive) is converted on parse (refio/gtf.py).
# BAM POS is already 0-based in the binary encoding.
# Output tables print Start 0-based, End exclusive (BED-like), matching the
# reference's BED-derived ref files.  [R:verify output basis]

# ---------------------------------------------------------------------------
# Read / fragment admission rules (SURVEY.md §2 row 7, BAM2blocks.cpp [R])
# ---------------------------------------------------------------------------

#: BAM FLAG bits that cause a read to be dropped before counting:
#: unmapped (0x4), secondary (0x100), QC-fail (0x200), duplicate? NO —
#: the reference counted duplicates (no dedup stage) [R:verify], and
#: supplementary (0x800).
FLAG_DROP_MASK = 0x4 | 0x100 | 0x800

#: Require primary unique alignments.  STAR marks unique mappers with
#: MAPQ 255; the reference filtered multimappers.  We drop reads with
#: MAPQ < MIN_MAPQ.  [R:verify — reference may have used the NH tag]
MIN_MAPQ = 5

#: Mates are paired by name-adjacency in aligner output order (the reference
#: requires name-collated input; SURVEY.md §3.3).  A read whose mate does not
#: follow/precede it contiguously is processed as a single-end fragment.
PAIR_BY_ADJACENCY = True

#: There is NO per-fragment block limit in the counting model: the flat
#: columnar batch layout (io/batch.py) admits any CIGAR, and the per-batch
#: block-column floor (MIN_CAP_UNITS = 4096) guarantees a single fragment —
#: even an ONT/PacBio full-length transcript alignment — always fits one
#: batch (tests/test_longread.py).  --long-reads only rebalances batch
#: geometry for throughput; semantics are identical (SURVEY.md §7.3 item 5's
#: anticipated "slow path" proved unnecessary).

#: If the two mates overlap, overlapping bases receive depth from BOTH mates
#: (the reference iterates each mate's blocks independently through every
#: processor; no mate-overlap dedup).  [R:verify]
MATE_OVERLAP_DOUBLE_COUNTS = True

# ---------------------------------------------------------------------------
# CIGAR semantics (SURVEY.md §2 row 7)
# ---------------------------------------------------------------------------
# M(0) I(1) D(2) N(3) S(4) H(5) P(6) =(7) X(8)
#   - M, D, =, X consume reference and extend the current aligned block
#     (deleted bases count as covered, matching the reference's block model).
#   - N ends the current block and opens a splice gap (recorded as junction).
#   - I, S, H, P consume no reference.
CIGAR_CONSUMES_REF = (True, False, True, True, False, False, False, True, True)
CIGAR_IS_GAP = (False, False, False, True, False, False, False, False, False)

#: Splice gaps shorter than this are treated as deletions (extend the block)
#: rather than junctions.  The reference treats every N op as a junction
#: regardless of length; keep 0 so behavior matches.  [R:verify]
MIN_GAP_AS_JUNCTION = 0

# ---------------------------------------------------------------------------
# Reference-map construction (SURVEY.md §2 row 3)
# ---------------------------------------------------------------------------

#: Buffer (bp) added around every annotated exon when building the global
#: exclusion-zone set.  [R:verify]
EXON_EXCLUSION_BUFFER = 0

#: Bases trimmed from each intron edge before measurement.  [R:verify]
INTRON_EDGE_TRIM = 0

#: An intron is classified "anti-near" when an antisense exon lies within this
#: many bp without overlapping it.  [R:verify]
ANTI_NEAR_DIST = 1000

#: Intron classification priority (first matching wins):
#:   known-exon : overlaps a sense-strand annotated exon of any gene
#:   anti-over  : overlaps an antisense-strand annotated exon
#:   anti-near  : antisense exon within ANTI_NEAR_DIST
#:   clean      : none of the above
#: [R:verify exact names + priority]
INTRON_CLASSES = ("clean", "known-exon", "anti-over", "anti-near")

# ---------------------------------------------------------------------------
# SpansPoint (exon-intron boundary reads; SURVEY.md §2 row 11)
# ---------------------------------------------------------------------------

#: A contiguous aligned block [s, e) "spans" boundary point p iff it covers at
#: least SPANS_OVERHANG bases on each side:  s <= p - OH  and  p + OH <= e.
#: [R:verify overhang constant]
SPANS_OVERHANG = 8

# ---------------------------------------------------------------------------
# IRratio and warning flags (SURVEY.md §3.4, BASELINE.json:5)
# ---------------------------------------------------------------------------


def splice_max(splice_left: int, splice_right: int) -> int:
    """Spliced-transcript abundance term of the IRratio denominator.

    The reference uses the larger of the two boundary splice counts.
    [R:verify — could instead involve SpliceExact]
    """
    return max(splice_left, splice_right)


def ir_ratio(intron_depth: float, splice_left: int, splice_right: int) -> float:
    """IRratio = intronic depth / (intronic depth + spliced abundance).

    BASELINE.json:5 states the numerator/denominator; the spliced term is
    splice_max().  Returns 0.0 when the denominator is zero (no signal).
    [R:verify zero-denominator behavior]
    """
    denom = intron_depth + splice_max(splice_left, splice_right)
    if denom <= 0.0:
        return 0.0
    return intron_depth / denom


#: LowCover: intron depth below this → unreliable IRratio numerator.
WARN_LOW_COVER_DEPTH = 3.0  # [R:verify]

#: LowSplicing: splice_max below this → unreliable denominator.
WARN_LOW_SPLICING_COUNT = 3  # [R:verify]

#: MinorIsoform: boundary splicing dominated by junctions that are not this
#: intron's exact junction (exact*MULT < splice_max).
WARN_MINOR_ISOFORM_MULT = 3  # [R:verify]

#: NonUniformIntronCover: inter-quartile depth spread exceeding the mean
#: indicates 5'/3' bias or internal features.
#:   (p75 - p25) > NONUNIFORM_IQR_VS_MEAN * IntronDepth
WARN_NONUNIFORM_IQR_VS_MEAN = 1.0  # [R:verify]

WARNING_NONE = "-"
WARNING_ORDER = ("LowCover", "LowSplicing", "MinorIsoform", "NonUniformIntronCover")


def warning_flag(
    intron_depth: float,
    p25: int,
    p75: int,
    splice_left: int,
    splice_right: int,
    splice_exact: int,
) -> str:
    """Per-intron QC warning, first matching rule wins.  [R:verify order]"""
    smax = splice_max(splice_left, splice_right)
    if intron_depth < WARN_LOW_COVER_DEPTH:
        return "LowCover"
    if smax < WARN_LOW_SPLICING_COUNT:
        return "LowSplicing"
    if splice_exact * WARN_MINOR_ISOFORM_MULT < smax:
        return "MinorIsoform"
    if (p75 - p25) > WARN_NONUNIFORM_IQR_VS_MEAN * intron_depth:
        return "NonUniformIntronCover"
    return WARNING_NONE


# ---------------------------------------------------------------------------
# Depth statistics (SURVEY.md §2 row 12)
# ---------------------------------------------------------------------------


def percentile_rank_index(p: float, n: int) -> int:
    """Nearest-rank percentile index into a sorted array of n depths.

    index = ceil(p*n) - 1, clamped to [0, n-1].  [R:verify tie-breaking]
    """
    if n <= 0:
        return 0
    return min(n - 1, max(0, int(math.ceil(p * n)) - 1))


#: Number of intron-edge bases over which IntronDepthFirst50bp /
#: IntronDepthLast50bp are averaged (over *included* bases, genomic order).
EDGE_DEPTH_WINDOW = 50  # [R:verify: raw-genomic vs included bases]

# ---------------------------------------------------------------------------
# Directionality detection (SURVEY.md §2 row 15)
# ---------------------------------------------------------------------------

#: Library is called stranded when the winning polarity explains at least
#: this fraction of strand-informative exact-junction reads.
DIR_CONCORDANCE_THRESHOLD = 0.85  # [R:verify]

#: Minimum strand-informative junction reads before a directionality call.
DIR_MIN_INFORMATIVE = 1000  # [R:verify]

# ---------------------------------------------------------------------------
# Output schema (SURVEY.md §2, column spec after row 22)
# ---------------------------------------------------------------------------

IR_TABLE_COLUMNS = (
    "Chr",
    "Start",
    "End",
    "Name",
    "Null",
    "Strand",
    "Coverage",
    "IntronDepth",
    "IntronDepth25thPercentile",
    "IntronDepth50thPercentile",
    "IntronDepth75thPercentile",
    "ExonToIntronReadsLeft",
    "ExonToIntronReadsRight",
    "IntronDepthFirst50bp",
    "IntronDepthLast50bp",
    "SpliceLeft",
    "SpliceRight",
    "SpliceExact",
    "IRratio",
    "Warnings",
)  # [R:verify column order]


@dataclasses.dataclass(frozen=True)
class IntronRow:
    """One fully-computed row of the IR table (pre-formatting)."""

    chrom: str
    start: int
    end: int
    name: str  # GeneSymbol/GeneID/class
    strand: str  # "+", "-", or "."
    coverage: float  # fraction of included bases with depth > 0
    intron_depth: float  # mean depth over included bases
    p25: int
    p50: int
    p75: int
    exon_intron_left: int
    exon_intron_right: int
    depth_first50: float
    depth_last50: float
    splice_left: int
    splice_right: int
    splice_exact: int

    @property
    def ir_ratio(self) -> float:
        return ir_ratio(self.intron_depth, self.splice_left, self.splice_right)

    @property
    def warning(self) -> str:
        return warning_flag(
            self.intron_depth,
            self.p25,
            self.p75,
            self.splice_left,
            self.splice_right,
            self.splice_exact,
        )


# ---------------------------------------------------------------------------
# Mappability exclusion generation (SURVEY.md §2 row 4).  The reference tiled
# the genome with synthetic error-free reads, remapped them with STAR, and
# excluded regions whose reads failed to map back uniquely [R:verify exact
# read length / stride; commonly 70nt / 10nt in the historical BuildRef].
MAPGEN_READ_LEN = 70  # [R:verify]
MAPGEN_STRIDE = 10  # [R:verify]

# ---------------------------------------------------------------------------
# Runtime overrides (SURVEY.md §0 verification protocol)
# ---------------------------------------------------------------------------
# Every [R:verify] constant above can be overridden WITHOUT editing code or
# rebuilding the native decoder: set IRTPU_SEMANTICS to a JSON object (inline
# or a file path), e.g.  IRTPU_SEMANTICS='{"MIN_MAPQ": 255}'.  Golden pinning
# then becomes a config edit + rerun.  The native decoder receives the live
# values per-handle through bd_open_ex (native/bamdecode.py), so both
# decoders always share the module's effective semantics.

#: names that may be overridden via IRTPU_SEMANTICS
OVERRIDABLE = (
    "FLAG_DROP_MASK",
    "MIN_MAPQ",
    "MIN_GAP_AS_JUNCTION",
    "EXON_EXCLUSION_BUFFER",
    "INTRON_EDGE_TRIM",
    "ANTI_NEAR_DIST",
    "SPANS_OVERHANG",
    "WARN_LOW_COVER_DEPTH",
    "WARN_LOW_SPLICING_COUNT",
    "WARN_MINOR_ISOFORM_MULT",
    "WARN_NONUNIFORM_IQR_VS_MEAN",
    "EDGE_DEPTH_WINDOW",
    "DIR_CONCORDANCE_THRESHOLD",
    "DIR_MIN_INFORMATIVE",
    "MAPGEN_READ_LEN",
    "MAPGEN_STRIDE",
)


def _apply_overrides() -> dict:
    """Parse IRTPU_SEMANTICS (inline JSON or a JSON file path) and override
    the whitelisted module constants.  Returns the applied mapping."""
    import json
    import os

    spec = os.environ.get("IRTPU_SEMANTICS")
    if not spec:
        return {}
    spec = spec.strip()
    if not spec.startswith("{"):
        with open(spec) as fh:
            spec = fh.read()
    overrides = json.loads(spec)
    applied = {}
    for k, v in overrides.items():
        if k not in OVERRIDABLE:
            raise ValueError(
                f"IRTPU_SEMANTICS: unknown/non-overridable constant {k!r} "
                f"(allowed: {', '.join(OVERRIDABLE)})"
            )
        default = globals()[k]
        globals()[k] = type(default)(v)
        applied[k] = globals()[k]
    return applied


SEMANTICS_OVERRIDES = _apply_overrides()
