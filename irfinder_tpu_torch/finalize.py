"""Counter finalization: dense counter arrays -> per-intron IR rows.

This is the engine analog of CoverageBlocksIRFinder::Output (SURVEY.md §3.4,
historical src/irfinder/ReadBlockProcessor_CoverageBlocks.cpp [R]): join
per-base depth, junction counts and boundary-span counts into one row per
intron, compute IRratio + warning flags (semantics).  Shared by
the NumPy oracle and the device engine so the row math is one code path; the
oracle/engine equivalence tests cover the counter arrays themselves.

Inputs are plain NumPy arrays with a leading strand axis (0 = forward
fragments, 1 = reverse):

    depth      (2, mbs_size)  per-included-base read depth
    start_cnt  (2, S)  splice gaps matching each unique intron start
    end_cnt    (2, E)
    exact_cnt  (2, X)  gaps matching a unique (start, end) pair
    span_hits  (2, P)  blocks spanning each unique boundary point
"""

from __future__ import annotations

import numpy as np

from . import semantics as S
from .native.tabfmt import StringPool
from .refio.compile import CompiledRef, STRAND_CHAR, derived


def _depth_stats_vectorized(ref: CompiledRef, dsum: np.ndarray, chunk: int = 256):
    """Per-intron depth statistics over CSR runs, vectorized in chunks.

    Returns (coverage, mean_depth, p25, p50, p75, first_w, last_w) arrays,
    numerically identical to the per-intron reference loop (the percentile is
    nearest-rank over the intron's sorted included-base depths; edge windows
    are positional over included bases in genomic order).

    chunk=256 keeps every temporary under glibc's mmap threshold so buffers
    are heap-recycled across chunks — large chunks made every temp a fresh
    mmap + page-fault storm (measured 13x slower at chunk=4096).
    """
    N = ref.n_introns
    cov = np.zeros(N)
    mean = np.zeros(N)
    p = np.zeros((3, N), dtype=np.int64)
    firstw = np.zeros(N)
    lastw = np.zeros(N)
    W = S.EDGE_DEPTH_WINDOW
    qs = (0.25, 0.50, 0.75)
    for i0 in range(0, N, chunk):
        i1 = min(N, i0 + chunk)
        r0, r1 = int(ref.intron_run_off[i0]), int(ref.intron_run_off[i1])
        lens = ref.run_len[r0:r1].astype(np.int64)
        if lens.size == 0 or lens.sum() == 0:
            continue
        starts = ref.run_mbs_start[r0:r1].astype(np.int64)
        total = int(lens.sum())
        # flattened per-base MBS indices of every (intron, run) pair
        rep_off = np.repeat(np.cumsum(lens) - lens, lens)
        pos = np.arange(total, dtype=np.int64) - rep_off
        vals = dsum[np.repeat(starts, lens) + pos].astype(np.int64)
        # per-intron segmentation
        n_per = (
            ref.intron_run_off[i0 + 1 : i1 + 1].astype(np.int64)
            - ref.intron_run_off[i0:i1]
        )
        n_bases = np.zeros(i1 - i0, dtype=np.int64)
        # bases per intron = sum of its runs' lens
        run_intron = np.repeat(np.arange(i1 - i0), n_per)
        np.add.at(n_bases, run_intron, lens)
        seg = np.concatenate([[0], np.cumsum(n_bases)])
        nz = n_bases > 0
        base_intron = np.repeat(np.arange(i1 - i0), n_bases)

        cs = np.concatenate([[0], np.cumsum(vals)])
        sums = cs[seg[1:]] - cs[seg[:-1]]
        csnz = np.concatenate([[0], np.cumsum(vals != 0)])
        nonzero = csnz[seg[1:]] - csnz[seg[:-1]]
        cov[i0:i1][nz] = nonzero[nz] / n_bases[nz]
        mean[i0:i1][nz] = sums[nz] / n_bases[nz]

        # exact nearest-rank percentiles WITHOUT sorting: depths are small
        # ints, so a per-intron counting histogram (capped at CAP-1, exact
        # fallback for the rare saturated intron) replaces the lexsort that
        # dominated finalize time at chromosome scale
        CAP = 256
        hist = np.bincount(
            base_intron * CAP + np.minimum(vals, CAP - 1),
            minlength=(i1 - i0) * CAP,
        ).reshape(i1 - i0, CAP)
        csum = np.cumsum(hist, axis=1)  # csum[i, v] = #bases with depth <= v
        saturated = np.zeros(i1 - i0, dtype=bool)
        for k, q in enumerate(qs):
            # nearest-rank index per intron: ceil(q*n)-1 clamped to [0, n-1]
            ridx = np.minimum(
                n_bases - 1, np.maximum(0, np.ceil(q * n_bases).astype(np.int64) - 1)
            )
            # sorted[ridx] = smallest v with csum[v] >= ridx+1
            pk = np.sum(csum < (ridx + 1)[:, None], axis=1).astype(np.int64)
            p[k, i0:i1] = np.where(nz, pk, 0)
            saturated |= nz & (pk >= CAP - 1)
        for i in np.nonzero(saturated)[0]:
            # exact path for introns whose percentile hit the histogram cap
            d = np.sort(vals[seg[i] : seg[i + 1]])
            for k, q in enumerate(qs):
                ridx = min(d.size - 1, max(0, int(np.ceil(q * d.size)) - 1))
                p[k, i0 + i] = d[ridx]

        w = np.minimum(W, n_bases)
        fw = np.zeros(i1 - i0)
        lw = np.zeros(i1 - i0)
        fw[nz] = (cs[(seg[:-1] + w)[nz]] - cs[seg[:-1]][nz]) / w[nz]
        lw[nz] = (cs[seg[1:]][nz] - cs[(seg[1:] - w)[nz]]) / w[nz]
        firstw[i0:i1] = fw
        lastw[i0:i1] = lw
    return cov, mean, p[0], p[1], p[2], firstw, lastw


def _intron_arrays(
    ref: CompiledRef,
    depth: np.ndarray,
    start_cnt: np.ndarray,
    end_cnt: np.ndarray,
    exact_cnt: np.ndarray,
    span_hits: np.ndarray,
    mode: str = "nondir",
    flip_strand: bool = False,
    stats_cache: dict | None = None,
) -> dict:
    """Shared column math behind intron_rows / intron_table: the vectorized
    host join (chunked NumPy over the CSR run structure; the per-intron
    reference loop is kept as intron_rows_loop and equivalence-tested).

    mode: "nondir" sums both fragment strands; "dir" keeps only fragments
    whose (optionally flipped) strand matches the intron strand.
    flip_strand: library polarity correction from detect_directionality()
    (fragment strand 0 maps to annotation '-' when True).
    stats_cache: optional dict shared across calls over the SAME depth
    arrays — the nondir and dir tables reuse each strand variant's depth
    statistics instead of recomputing them (engine.results passes one).
    """
    istrand = ref.intron_strand.astype(np.int64)
    if mode == "nondir":
        variant = np.full(ref.n_introns, 2, dtype=np.int64)  # both strands
    else:
        want = np.where(flip_strand, 1 - istrand, istrand)
        variant = np.where(istrand >= 2, 2, want)

    # depth stats for each needed strand variant (0, 1, both)
    stats = stats_cache if stats_cache is not None else {}
    for v in np.unique(variant):
        v = int(v)
        if v in stats:
            continue
        dsum = depth[0] + depth[1] if v == 2 else depth[v]
        stats[v] = _depth_stats_vectorized(ref, dsum.astype(np.int64))

    def pick(stat_idx):
        out = np.zeros(ref.n_introns, dtype=stats[int(variant[0])][stat_idx].dtype)
        for v, st_ in stats.items():
            m = variant == v
            out[m] = st_[stat_idx][m]
        return out

    cov, mean, p25, p50, p75, firstw, lastw = (pick(k) for k in range(7))

    def cnt(arr, idx_col):
        if mode == "nondir":
            return arr[0, idx_col].astype(np.int64) + arr[1, idx_col].astype(np.int64)
        both = arr[0, idx_col].astype(np.int64) + arr[1, idx_col].astype(np.int64)
        one = arr[np.minimum(variant, 1), idx_col].astype(np.int64)
        return np.where(variant == 2, both, one)

    sl = cnt(start_cnt, ref.intron_bstart_idx)
    sr = cnt(end_cnt, ref.intron_bend_idx)
    sx = cnt(exact_cnt, ref.intron_pair_idx)
    eil = cnt(span_hits, ref.intron_pstart_idx)
    eir = cnt(span_hits, ref.intron_pend_idx)
    return {
        "istrand": istrand, "cov": cov, "mean": mean,
        "p25": p25, "p50": p50, "p75": p75,
        "firstw": firstw, "lastw": lastw,
        "eil": eil, "eir": eir, "sl": sl, "sr": sr, "sx": sx,
    }


def ratio_warning_arrays(a: dict) -> tuple:
    """Vectorized IRratio + warning code per intron, numerically identical
    to the scalar semantics.ir_ratio / semantics.warning_flag (same float64
    operations in the same order; equivalence-tested).  Warning codes index
    (WARNING_NONE,) + WARNING_ORDER."""
    mean, sl, sr, sx = a["mean"], a["sl"], a["sr"], a["sx"]
    smax = np.maximum(sl, sr)
    denom = mean + smax
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(denom > 0.0, mean / np.where(denom > 0.0, denom, 1.0), 0.0)
    widx = np.select(
        [
            mean < S.WARN_LOW_COVER_DEPTH,
            smax < S.WARN_LOW_SPLICING_COUNT,
            sx * S.WARN_MINOR_ISOFORM_MULT < smax,
            (a["p75"] - a["p25"]) > S.WARN_NONUNIFORM_IQR_VS_MEAN * mean,
        ],
        [1, 2, 3, 4],
        default=0,
    ).astype(np.int32)
    return ratio, widx


def intron_name_pool(ref: CompiledRef) -> StringPool:
    """The StringPool of ``ref.intron_names``, made once per map (derived);
    made anew when the list is replaced by another."""
    return derived(ref, "intron_name_pool", ("intron_names",), lambda: StringPool(ref.intron_names))


class IRTable:
    """Column-oriented IR table: everything intron_rows computes, kept as
    arrays so format.write_ir_table can render the whole table in one
    native call (native/tabfmt).  Iterates as IntronRow records for
    compatibility with row consumers."""

    def __init__(self, ref: CompiledRef, arrays: dict):
        self.ref = ref
        self.a = arrays

    def __len__(self) -> int:
        return int(self.ref.n_introns)

    def rows(self) -> list:
        a, ref = self.a, self.ref
        chroms = ref.chroms
        cols = (
            [chroms[c] for c in ref.intron_chrom.tolist()],
            ref.intron_start.tolist(),
            ref.intron_end.tolist(),
            ref.intron_names,
            [STRAND_CHAR[s] for s in a["istrand"].tolist()],
            a["cov"].tolist(),
            a["mean"].tolist(),
            a["p25"].tolist(),
            a["p50"].tolist(),
            a["p75"].tolist(),
            a["eil"].tolist(),
            a["eir"].tolist(),
            a["firstw"].tolist(),
            a["lastw"].tolist(),
            a["sl"].tolist(),
            a["sr"].tolist(),
            a["sx"].tolist(),
        )
        return [S.IntronRow(*vals) for vals in zip(*cols)]

    def __iter__(self):
        return iter(self.rows())

    def native_columns(self) -> list:
        """The 20-column spec for native/tabfmt.format_table, including the
        vectorized IRratio + warning columns; the names column reads the
        map's pool (intron_name_pool)."""
        a, ref = self.a, self.ref
        n = int(ref.n_introns)
        ratio, widx = ratio_warning_arrays(a)
        return [
            ("s", ref.intron_chrom, ref.chroms),
            ("i", ref.intron_start),
            ("i", ref.intron_end),
            ("s", np.arange(n, dtype=np.int32), intron_name_pool(ref)),
            ("i", np.zeros(n, np.int64)),  # Null placeholder column
            ("s", a["istrand"], [STRAND_CHAR[k] for k in sorted(STRAND_CHAR)]),
            ("g", a["cov"]),
            ("g", a["mean"]),
            ("i", a["p25"]),
            ("i", a["p50"]),
            ("i", a["p75"]),
            ("i", a["eil"]),
            ("i", a["eir"]),
            ("g", a["firstw"]),
            ("g", a["lastw"]),
            ("i", a["sl"]),
            ("i", a["sr"]),
            ("i", a["sx"]),
            ("g", ratio),
            ("s", widx, [S.WARNING_NONE, *S.WARNING_ORDER]),
        ]


def intron_table(
    ref: CompiledRef,
    depth: np.ndarray,
    start_cnt: np.ndarray,
    end_cnt: np.ndarray,
    exact_cnt: np.ndarray,
    span_hits: np.ndarray,
    mode: str = "nondir",
    flip_strand: bool = False,
    stats_cache: dict | None = None,
) -> IRTable:
    """Column-oriented variant of intron_rows (same math, same arguments):
    what the engine result paths hold so table writing stays bulk/native."""
    return IRTable(
        ref,
        _intron_arrays(
            ref, depth, start_cnt, end_cnt, exact_cnt, span_hits,
            mode=mode, flip_strand=flip_strand, stats_cache=stats_cache,
        ),
    )


def intron_rows(
    ref: CompiledRef,
    depth: np.ndarray,
    start_cnt: np.ndarray,
    end_cnt: np.ndarray,
    exact_cnt: np.ndarray,
    span_hits: np.ndarray,
    mode: str = "nondir",
    flip_strand: bool = False,
    stats_cache: dict | None = None,
) -> list:
    """Finalize counters into IntronRow records (see _intron_arrays for the
    vectorized join)."""
    return intron_table(
        ref, depth, start_cnt, end_cnt, exact_cnt, span_hits,
        mode=mode, flip_strand=flip_strand, stats_cache=stats_cache,
    ).rows()


def intron_rows_loop(
    ref: CompiledRef,
    depth: np.ndarray,
    start_cnt: np.ndarray,
    end_cnt: np.ndarray,
    exact_cnt: np.ndarray,
    span_hits: np.ndarray,
    mode: str = "nondir",
    flip_strand: bool = False,
) -> list:
    """Per-intron reference implementation (the original scalar join): the
    oracle that tests/test_torch_finalize_stats.py holds intron_rows and
    intron_table (with the device statistics as its stats_cache) to."""
    rows = []
    for i in range(ref.n_introns):
        istrand = int(ref.intron_strand[i])
        if mode == "nondir":
            sel = (0, 1)
        else:
            want = istrand if not flip_strand else 1 - istrand
            sel = (want,) if istrand in (0, 1) else (0, 1)

        def cnt(arr, idx):
            return int(sum(arr[s, idx] for s in sel))

        # depth over the intron's included bases (CSR runs into MBS)
        runs = slice(int(ref.intron_run_off[i]), int(ref.intron_run_off[i + 1]))
        dsum = sum(depth[s] for s in sel)
        pieces = [
            dsum[m : m + l]
            for m, l in zip(ref.run_mbs_start[runs], ref.run_len[runs])
        ]
        d = np.concatenate(pieces) if pieces else np.zeros(0, dtype=np.int64)
        n = d.size
        if n:
            ds = np.sort(d)
            coverage = float(np.count_nonzero(d)) / n
            mean_depth = float(d.sum()) / n
            p25 = int(ds[S.percentile_rank_index(0.25, n)])
            p50 = int(ds[S.percentile_rank_index(0.50, n)])
            p75 = int(ds[S.percentile_rank_index(0.75, n)])
            w = min(S.EDGE_DEPTH_WINDOW, n)
            first50 = float(d[:w].sum()) / w
            last50 = float(d[-w:].sum()) / w
        else:
            coverage = mean_depth = first50 = last50 = 0.0
            p25 = p50 = p75 = 0

        rows.append(
            S.IntronRow(
                chrom=ref.chroms[int(ref.intron_chrom[i])],
                start=int(ref.intron_start[i]),
                end=int(ref.intron_end[i]),
                name=ref.intron_names[i],
                strand=STRAND_CHAR[istrand],
                coverage=coverage,
                intron_depth=mean_depth,
                p25=p25,
                p50=p50,
                p75=p75,
                exon_intron_left=cnt(span_hits, int(ref.intron_pstart_idx[i])),
                exon_intron_right=cnt(span_hits, int(ref.intron_pend_idx[i])),
                depth_first50=first50,
                depth_last50=last50,
                splice_left=cnt(start_cnt, int(ref.intron_bstart_idx[i])),
                splice_right=cnt(end_cnt, int(ref.intron_bend_idx[i])),
                splice_exact=cnt(exact_cnt, int(ref.intron_pair_idx[i])),
            )
        )
    return rows


#: the map's fields the junction join's tables are made from
_JUNCTION_TABLE_FIELDS = (
    "bstart_coord", "bstart_seg", "bend_coord", "bend_seg", "upair_start", "upair_end", "upair_seg",
)


def _chrom_keys(seg: np.ndarray, coord: np.ndarray) -> np.ndarray:
    """chrom << 32 | coord of a table segmented by chromosome (sorted)."""
    chrom = np.repeat(np.arange(len(seg) - 1, dtype=np.int64), np.diff(seg))
    return chrom << 32 | coord.astype(np.int64)


def _make_junction_tables(ref: CompiledRef) -> tuple:
    start_key = _chrom_keys(ref.bstart_seg, ref.bstart_coord)
    end_key = _chrom_keys(ref.bend_seg, ref.bend_coord)
    # a pair is its (start index, end index): its start and end are an
    # intron's, so both are in the tables
    si = np.searchsorted(start_key, _chrom_keys(ref.upair_seg, ref.upair_start))
    ei = np.searchsorted(end_key, _chrom_keys(ref.upair_seg, ref.upair_end))
    pair_key = si.astype(np.int64) << 32 | ei
    pair_order = np.argsort(pair_key, kind="stable")
    return start_key, end_key, pair_key[pair_order], pair_order


def junction_tables(ref: CompiledRef) -> tuple:
    """((start_key, end_key, pair_key, pair_order), made): the map's side of
    the junction join, made once per map (derived) and anew when a field it
    comes from is replaced; ``made`` says whether this call made it.  A
    start or end is chrom << 32 | coord, sorted as the map's unique tables;
    a pair is start index << 32 | end index, sorted, ``pair_order`` its
    index in the map's pair table."""
    made = []

    def make():
        made.append(True)
        return _make_junction_tables(ref)

    return derived(ref, "junction_tables", _JUNCTION_TABLE_FIELDS, make), bool(made)


def _lookup(table: np.ndarray, query: np.ndarray) -> tuple:
    """(index, hit): where each query key sits in the sorted ``table``, and
    whether it is there."""
    if table.size == 0:
        return np.zeros(query.size, np.intp), np.zeros(query.size, bool)
    j = np.minimum(np.searchsorted(table, query), table.size - 1)
    return j, table[j] == query


def _strand_sums(idx: np.ndarray, hit: np.ndarray, vals: np.ndarray, size: int) -> np.ndarray:
    """int32 (2, size): each strand's vals of the hit rows summed by index."""
    rows = np.flatnonzero(hit)
    at = idx[rows]
    return np.stack(
        [np.bincount(at, weights=vals[rows, s], minlength=size) for s in (0, 1)]
    ).astype(np.int32)


def junction_counters(ref: CompiledRef, junc_tally):
    """Host-side junction counters from the sparse per-batch tally
    (junctions.JuncTally; plain dicts also accepted):
    strand-resolved counts of observed splice gaps matching each unique
    intron start / end / (start,end) pair.

    Matching against the map's tables (junction_tables, made once per map)
    is two searchsorted passes over the tally's packed chrom << 32 | coord
    keys, and one over the (start index, end index) of the rows that hit
    both.  Returns (start_cnt, end_cnt, exact_cnt), each int32
    (2, table_size) — exactly what the device used to produce before
    junction counting moved off the hot step (ops/step.py docstring).
    """
    from .junctions import coerce_tally

    keys, vals = coerce_tally(junc_tally).merged()  # (n,3) sorted, (n,2)
    start_key, end_key, pair_key, pair_order = junction_tables(ref)[0]
    chrom = keys[:, 0] << 32
    js, hs = _lookup(start_key, chrom | keys[:, 1])
    je, he = _lookup(end_key, chrom | keys[:, 2])
    both = np.flatnonzero(hs & he)
    jp, hp = _lookup(pair_key, js[both].astype(np.int64) << 32 | je[both])
    return (
        _strand_sums(js, hs, vals, start_key.size),
        _strand_sums(je, he, vals, end_key.size),
        _strand_sums(pair_order[jp], hp, vals[both], pair_key.size),
    )


def _make_pair_strands(ref: CompiledRef) -> np.ndarray:
    seen = np.zeros((ref.upair_start.size, 3), bool)  # strands 0/1/2 per pair
    seen[ref.intron_pair_idx, ref.intron_strand] = True
    ps = np.where(seen.sum(axis=1) == 1, seen.argmax(axis=1), 2).astype(np.int8)
    ps.flags.writeable = False
    return ps


def pair_strands(ref: CompiledRef) -> np.ndarray:
    """Annotation strand per unique (start, end) junction pair: 0/1 when all
    introns sharing the pair agree, 2 when unknown or conflicting.  Made
    once per map (derived; read-only)."""
    return derived(
        ref, "pair_strands", ("upair_start", "intron_pair_idx", "intron_strand"),
        lambda: _make_pair_strands(ref),
    )


def detect_directionality(ref: CompiledRef, exact_cnt: np.ndarray):
    """Library strandedness call from strand-resolved exact-junction counts
    over introns of known direction (SURVEY.md §2 row 15 [R:verify rule]).

    Returns (is_stranded, flip_strand, concordance_fraction, n_informative):
    flip_strand=True means fragment strand 0 corresponds to annotation '-'
    (e.g. dUTP/fr-firststrand libraries).
    """
    ps = pair_strands(ref)
    known = np.nonzero((ps == 0) | (ps == 1))[0]
    if known.size == 0:
        return False, False, 0.0, 0
    k_strand = ps[known].astype(np.int64)
    same = int(exact_cnt[k_strand, known].sum())
    opposite = int(exact_cnt[1 - k_strand, known].sum())
    total = same + opposite
    if total < S.DIR_MIN_INFORMATIVE:
        return False, False, 0.0, total
    frac = max(same, opposite) / total
    return frac >= S.DIR_CONCORDANCE_THRESHOLD, opposite > same, frac, total
