"""Reference compiler: GTF annotation -> dense sorted coordinate tensors.

TPU-native replacement for IRFinder's BuildRefProcess awk/perl pipeline
(SURVEY.md §2 row 3; behavior reconstructed per SURVEY.md §0).  Instead of a directory
of BED files, the compiler emits NumPy arrays shaped for direct device
residency (BASELINE.json:5: "dense sorted coordinate tensors sharded by
chromosome"):

* the intron row table (one row per (gene, unique intron coordinates)),
* the **measured-base space (MBS)**: the union of all non-excluded intronic
  bases, as disjoint sorted spans with prefix offsets.  This is the engine's
  key departure from the reference design: per-read depth accumulation
  becomes exactly TWO scatter-adds into a diff array over MBS (see
  ops/step.py), with per-intron stats recovered at finalize from
  per-intron CSR runs into MBS,
* unique intron boundary / exact-junction / spans-point coordinate tables
  with per-chromosome segment offsets (device binary-search targets),
* ROI interval tables.

All behavioral constants come from semantics.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from typing import Iterable, Sequence

import numpy as np

from .. import semantics as S
from ..utils.intervals import any_overlap, merge_intervals, min_distance, subtract_from_interval
from .gtf import Exon

STRAND_CODE = {"+": 0, "-": 1, ".": 2}
STRAND_CHAR = {0: "+", 1: "-", 2: "."}


@dataclasses.dataclass
class CompiledRef:
    """All reference tensors, host-resident.  Device subsets are derived in
    ops/device_ref.py."""

    chroms: list  # ordered chromosome names
    # --- intron rows, sorted by (chrom_idx, start, end, gene_id) ---
    intron_chrom: np.ndarray  # int32 (N,)
    intron_start: np.ndarray  # int32 (N,)
    intron_end: np.ndarray  # int32 (N,)
    intron_strand: np.ndarray  # int8 (N,)  0/1/2
    intron_class: np.ndarray  # int8 (N,)  index into semantics.INTRON_CLASSES
    intron_names: list  # (N,) "GeneSymbol/GeneID/class"
    # --- measured-base space (disjoint sorted union of included bases) ---
    uspan_start: np.ndarray  # int32 (U,)
    uspan_end: np.ndarray  # int32 (U,)
    uspan_mbs_off: np.ndarray  # int64 (U+1,) prefix offsets; [-1] == mbs_size
    uspan_seg: np.ndarray  # int32 (n_chroms+1,) per-chrom segment into uspans
    # --- per-intron included runs in MBS (CSR) ---
    intron_run_off: np.ndarray  # int32 (N+1,)
    run_mbs_start: np.ndarray  # int64 (R,)
    run_len: np.ndarray  # int32 (R,)
    # --- unique boundary coordinate tables (device scatter targets) ---
    bstart_coord: np.ndarray  # int32 (S,)   unique intron starts
    bstart_seg: np.ndarray  # int32 (n_chroms+1,)
    bend_coord: np.ndarray  # int32 (E,)   unique intron ends
    bend_seg: np.ndarray
    upair_start: np.ndarray  # int32 (X,)  unique (start,end) pairs
    upair_end: np.ndarray
    upair_seg: np.ndarray
    point_coord: np.ndarray  # int32 (P,)  unique boundary points (starts+ends)
    point_seg: np.ndarray
    # --- intron row -> table index maps ---
    intron_bstart_idx: np.ndarray  # int32 (N,)
    intron_bend_idx: np.ndarray
    intron_pair_idx: np.ndarray
    intron_pstart_idx: np.ndarray
    intron_pend_idx: np.ndarray
    # --- ROI ---
    roi_start: np.ndarray  # int32 (Rr,)
    roi_end: np.ndarray
    roi_seg: np.ndarray  # int32 (n_chroms+1,)
    roi_strand: np.ndarray  # int8
    roi_names: list

    @property
    def n_introns(self) -> int:
        return int(self.intron_start.size)

    @property
    def mbs_size(self) -> int:
        return int(self.uspan_mbs_off[-1]) if self.uspan_mbs_off.size else 0

    @property
    def n_chroms(self) -> int:
        return len(self.chroms)

    # -- serialization ------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        arrays = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), np.ndarray)
        }
        np.savez_compressed(os.path.join(path, "ref.npz"), **arrays)
        meta = {
            "chroms": list(self.chroms),
            "intron_names": list(self.intron_names),
            "roi_names": list(self.roi_names),
            "semantics": {
                "SPANS_OVERHANG": S.SPANS_OVERHANG,
                "EXON_EXCLUSION_BUFFER": S.EXON_EXCLUSION_BUFFER,
                "ANTI_NEAR_DIST": S.ANTI_NEAR_DIST,
            },
        }
        with open(os.path.join(path, "ref.json"), "w") as fh:
            json.dump(meta, fh)

    @classmethod
    def load(cls, path: str) -> "CompiledRef":
        with open(os.path.join(path, "ref.json")) as fh:
            meta = json.load(fh)
        data = np.load(os.path.join(path, "ref.npz"))
        kwargs = {k: data[k] for k in data.files}
        return cls(
            chroms=meta["chroms"],
            intron_names=meta["intron_names"],
            roi_names=meta["roi_names"],
            **kwargs,
        )


def derived(ref, key, fields: tuple, make):
    """``make()``, cached on ``ref`` under ``key`` for as long as each of
    ``ref``'s ``fields`` (the fields the value is made from) is the object
    it was made from: replacing one of them makes the value anew."""
    cache = vars(ref).setdefault("_irtorch_derived", {})
    deps = tuple(getattr(ref, f) for f in fields)
    hit = cache.get(key)
    if hit is None or any(a is not b for a, b in zip(hit[0], deps)):
        hit = cache[key] = (deps, make())
    return hit[1]


def _unique_sorted_with_seg(
    chrom_idx: np.ndarray, coords: np.ndarray, n_chroms: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unique (chrom, coord) pairs sorted by (chrom, coord); returns
    (coord_array, seg_offsets, inverse_index mapping input rows -> table idx)."""
    key = chrom_idx.astype(np.int64) << 32 | coords.astype(np.int64)
    uniq, inverse = np.unique(key, return_inverse=True)
    u_chrom = (uniq >> 32).astype(np.int32)
    u_coord = (uniq & 0xFFFFFFFF).astype(np.int32)
    seg = np.searchsorted(u_chrom, np.arange(n_chroms + 1)).astype(np.int32)
    return u_coord, seg, inverse.astype(np.int32)


def compile_reference(
    exons: Iterable[Exon],
    chrom_order: Sequence[str] | None = None,
    extra_exclusions: dict | None = None,
    rois: Sequence[tuple] | None = None,
) -> CompiledRef:
    """Compile an exon annotation into a CompiledRef.

    extra_exclusions: {chrom: (starts, ends)} additional exclusion intervals
        (low-mappability zones, blacklist — SURVEY.md §2 row 4; generated
        externally or consumed from a precomputed BED).
    rois: iterable of (chrom, start, end, name, strand) regions of interest
        (rRNA / Mt / ERCC; SURVEY.md §2 row 13).
    """
    exons = list(exons)

    # chromosome order: explicit, else first appearance in the annotation
    if chrom_order is None:
        chrom_order = []
        seen = set()
        for ex in exons:
            if ex.chrom not in seen:
                seen.add(ex.chrom)
                chrom_order.append(ex.chrom)
        for roi in rois or []:
            if roi[0] not in seen:
                seen.add(roi[0])
                chrom_order.append(roi[0])
    chroms = list(chrom_order)
    chrom_idx_of = {c: i for i, c in enumerate(chroms)}
    n_chroms = len(chroms)

    # ---- group exons by transcript; derive introns per transcript --------
    tx_exons: dict = defaultdict(list)
    gene_meta: dict = {}
    for ex in exons:
        if ex.chrom not in chrom_idx_of:
            continue
        tx_exons[(ex.gene_id, ex.transcript_id)].append(ex)
        gene_meta[ex.gene_id] = (ex.gene_name, ex.strand, ex.chrom)

    # unique introns per gene: {(gene_id) -> set of (chrom_idx, start, end)}
    gene_introns: dict = defaultdict(set)
    for (gene_id, _tx), exl in tx_exons.items():
        exl.sort(key=lambda e: (e.start, e.end))
        for a, b in zip(exl, exl[1:]):
            if b.start > a.end:  # a real gap
                gene_introns[gene_id].add((chrom_idx_of[a.chrom], a.end, b.start))

    # ---- per-(chrom, strand) merged exon interval sets --------------------
    ex_by_cs: dict = defaultdict(lambda: ([], []))
    for ex in exons:
        if ex.chrom not in chrom_idx_of:
            continue
        sidx = STRAND_CODE.get(ex.strand, 2)
        st, en = ex_by_cs[(chrom_idx_of[ex.chrom], sidx)]
        st.append(ex.start)
        en.append(ex.end)
    merged_cs = {
        key: merge_intervals(np.array(st), np.array(en)) for key, (st, en) in ex_by_cs.items()
    }

    # ---- global exclusion set per chrom (all exons buffered + extras) ----
    excl_by_chrom: dict = {}
    for c in range(n_chroms):
        st_list, en_list = [], []
        for sidx in (0, 1, 2):
            if (c, sidx) in merged_cs:
                st, en = merged_cs[(c, sidx)]
                st_list.append(st - S.EXON_EXCLUSION_BUFFER)
                en_list.append(en + S.EXON_EXCLUSION_BUFFER)
        if extra_exclusions and chroms[c] in extra_exclusions:
            xs, xe = extra_exclusions[chroms[c]]
            st_list.append(np.asarray(xs, dtype=np.int64))
            en_list.append(np.asarray(xe, dtype=np.int64))
        if st_list:
            excl_by_chrom[c] = merge_intervals(
                np.concatenate(st_list), np.concatenate(en_list)
            )
        else:
            excl_by_chrom[c] = (np.zeros(0, np.int64), np.zeros(0, np.int64))

    # ---- flatten intron rows ----------------------------------------------
    rows = []  # (chrom_idx, start, end, gene_id)
    for gene_id, iset in gene_introns.items():
        for (c, s, e) in iset:
            rows.append((c, s, e, gene_id))
    rows.sort(key=lambda r: (r[0], r[1], r[2], r[3]))
    n = len(rows)

    intron_chrom = np.array([r[0] for r in rows], dtype=np.int32).reshape(n)
    intron_start = np.array([r[1] for r in rows], dtype=np.int32).reshape(n)
    intron_end = np.array([r[2] for r in rows], dtype=np.int32).reshape(n)
    gene_ids = [r[3] for r in rows]
    intron_strand = np.array(
        [STRAND_CODE.get(gene_meta[g][1], 2) for g in gene_ids], dtype=np.int8
    ).reshape(n)

    # ---- classification (semantics.INTRON_CLASSES) ------------------------
    intron_class = np.zeros(n, dtype=np.int8)
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    for c in range(n_chroms):
        mask = intron_chrom == c
        if not mask.any():
            continue
        qs = intron_start[mask].astype(np.int64)
        qe = intron_end[mask].astype(np.int64)
        strands = intron_strand[mask]
        cls = np.zeros(qs.size, dtype=np.int8)
        for sidx in (0, 1):
            sel = strands == sidx
            if not sel.any():
                continue
            sense = merged_cs.get((c, sidx), empty)
            anti = merged_cs.get((c, 1 - sidx), empty)
            sense_over = any_overlap(sense[0], sense[1], qs[sel], qe[sel])
            anti_dist = min_distance(anti[0], anti[1], qs[sel], qe[sel])
            sub = np.zeros(sel.sum(), dtype=np.int8)
            sub[anti_dist <= S.ANTI_NEAR_DIST] = 3  # anti-near
            sub[anti_dist == 0] = 2  # anti-over
            sub[sense_over] = 1  # known-exon (highest priority)
            cls[sel] = sub
        intron_class[mask] = cls

    intron_names = [
        f"{gene_meta[g][0]}/{g}/{S.INTRON_CLASSES[intron_class[i]]}"
        for i, g in enumerate(gene_ids)
    ]

    # ---- included intervals per intron; MBS union -------------------------
    included_per_intron: list = []
    for i in range(n):
        c = int(intron_chrom[i])
        s = int(intron_start[i]) + S.INTRON_EDGE_TRIM
        e = int(intron_end[i]) - S.INTRON_EDGE_TRIM
        ex_s, ex_e = excl_by_chrom[c]
        included_per_intron.append(subtract_from_interval(s, e, ex_s, ex_e))

    uspan_start_l, uspan_end_l, uspan_seg = [], [], [0]
    for c in range(n_chroms):
        st_list, en_list = [], []
        for i in np.nonzero(intron_chrom == c)[0]:
            for (a, b) in included_per_intron[i]:
                st_list.append(a)
                en_list.append(b)
        if st_list:
            ms, me = merge_intervals(np.array(st_list), np.array(en_list))
        else:
            ms, me = empty
        uspan_start_l.append(ms)
        uspan_end_l.append(me)
        uspan_seg.append(uspan_seg[-1] + ms.size)
    uspan_start = (
        np.concatenate(uspan_start_l).astype(np.int32) if uspan_start_l else np.zeros(0, np.int32)
    )
    uspan_end = (
        np.concatenate(uspan_end_l).astype(np.int32) if uspan_end_l else np.zeros(0, np.int32)
    )
    uspan_seg = np.array(uspan_seg, dtype=np.int32)
    lens = (uspan_end - uspan_start).astype(np.int64)
    uspan_mbs_off = np.zeros(uspan_start.size + 1, dtype=np.int64)
    np.cumsum(lens, out=uspan_mbs_off[1:])

    def mbs_rank(c: int, pos: int) -> int:
        """Number of included bases on chrom c strictly before pos (global MBS
        index of pos if pos is included)."""
        lo, hi = int(uspan_seg[c]), int(uspan_seg[c + 1])
        j = int(np.searchsorted(uspan_start[lo:hi], pos, side="right")) - 1 + lo
        if j < lo:
            return int(uspan_mbs_off[lo])
        return int(uspan_mbs_off[j]) + min(max(pos - int(uspan_start[j]), 0), int(uspan_end[j] - uspan_start[j]))

    intron_run_off = np.zeros(n + 1, dtype=np.int32)
    run_mbs_start_l, run_len_l = [], []
    for i in range(n):
        c = int(intron_chrom[i])
        for (a, b) in included_per_intron[i]:
            run_mbs_start_l.append(mbs_rank(c, a))
            run_len_l.append(b - a)
        intron_run_off[i + 1] = len(run_mbs_start_l)
    run_mbs_start = np.array(run_mbs_start_l, dtype=np.int64).reshape(len(run_mbs_start_l))
    run_len = np.array(run_len_l, dtype=np.int32).reshape(len(run_len_l))

    # ---- unique boundary / pair / point tables ----------------------------
    bstart_coord, bstart_seg, intron_bstart_idx = _unique_sorted_with_seg(
        intron_chrom, intron_start, n_chroms
    )
    bend_coord, bend_seg, intron_bend_idx = _unique_sorted_with_seg(
        intron_chrom, intron_end, n_chroms
    )
    # exact pairs: unique (chrom, start, end) triples via lexsort + run-length
    order = np.lexsort((intron_end, intron_start, intron_chrom))
    trip = np.stack(
        [intron_chrom[order], intron_start[order], intron_end[order]], axis=1
    ).astype(np.int64)
    keep = np.ones(n, dtype=bool)
    if n > 1:
        keep[1:] = (trip[1:] != trip[:-1]).any(axis=1)
    uniq_rows = trip[keep]
    upair_start = uniq_rows[:, 1].astype(np.int32) if n else np.zeros(0, np.int32)
    upair_end = uniq_rows[:, 2].astype(np.int32) if n else np.zeros(0, np.int32)
    upair_chrom = uniq_rows[:, 0].astype(np.int32) if n else np.zeros(0, np.int32)
    upair_seg = np.searchsorted(upair_chrom, np.arange(n_chroms + 1)).astype(np.int32)
    # map each intron row to its unique pair index
    pair_pos = np.cumsum(keep) - 1
    intron_pair_idx = np.zeros(n, dtype=np.int32)
    intron_pair_idx[order] = pair_pos.astype(np.int32)

    point_chrom2 = np.concatenate([intron_chrom, intron_chrom]) if n else np.zeros(0, np.int32)
    point_coord2 = np.concatenate([intron_start, intron_end]) if n else np.zeros(0, np.int32)
    point_coord, point_seg, point_inverse = _unique_sorted_with_seg(
        point_chrom2, point_coord2, n_chroms
    )
    intron_pstart_idx = point_inverse[:n] if n else np.zeros(0, np.int32)
    intron_pend_idx = point_inverse[n:] if n else np.zeros(0, np.int32)

    # ---- ROI ---------------------------------------------------------------
    roi_list = sorted(
        [
            (chrom_idx_of[r[0]], int(r[1]), int(r[2]), str(r[3]), STRAND_CODE.get(r[4] if len(r) > 4 else ".", 2))
            for r in (rois or [])
            if r[0] in chrom_idx_of
        ]
    )
    roi_chrom = np.array([r[0] for r in roi_list], dtype=np.int32).reshape(len(roi_list))
    roi_start = np.array([r[1] for r in roi_list], dtype=np.int32).reshape(len(roi_list))
    roi_end = np.array([r[2] for r in roi_list], dtype=np.int32).reshape(len(roi_list))
    roi_strand = np.array([r[4] for r in roi_list], dtype=np.int8).reshape(len(roi_list))
    roi_names = [r[3] for r in roi_list]
    roi_seg = np.searchsorted(roi_chrom, np.arange(n_chroms + 1)).astype(np.int32)

    return CompiledRef(
        chroms=chroms,
        intron_chrom=intron_chrom,
        intron_start=intron_start,
        intron_end=intron_end,
        intron_strand=intron_strand,
        intron_class=intron_class,
        intron_names=intron_names,
        uspan_start=uspan_start,
        uspan_end=uspan_end,
        uspan_mbs_off=uspan_mbs_off,
        uspan_seg=uspan_seg,
        intron_run_off=intron_run_off,
        run_mbs_start=run_mbs_start,
        run_len=run_len,
        bstart_coord=bstart_coord,
        bstart_seg=bstart_seg,
        bend_coord=bend_coord,
        bend_seg=bend_seg,
        upair_start=upair_start,
        upair_end=upair_end,
        upair_seg=upair_seg,
        point_coord=point_coord,
        point_seg=point_seg,
        intron_bstart_idx=intron_bstart_idx,
        intron_bend_idx=intron_bend_idx,
        intron_pair_idx=intron_pair_idx,
        intron_pstart_idx=intron_pstart_idx,
        intron_pend_idx=intron_pend_idx,
        roi_start=roi_start,
        roi_end=roi_end,
        roi_seg=roi_seg,
        roi_strand=roi_strand,
        roi_names=roi_names,
    )
