"""Plain NumPy counters for the benchmark's reference: what IRFinder counts
from the decoded fragments of one BAM, against a compiled map.

Written for the benchmark from the counting rules as the port states them
(its oracle.py), vectorized over the whole file:

* depth: +1 over the measured bases (MBS) of every aligned block, per
  fragment strand;
* span hits: a block [s, e) spans boundary point p iff s + OH <= p <= e - OH
  (OH = SPANS_OVERHANG), counted for blocks of at least 2 * OH bases;
* ROI: a fragment counts once in each region of interest that its span
  [start, end) overlaps;
* fragments per BAM reference, and the number of fragments;
* the junction tally: every splice gap on a mapped chromosome, keyed by
  (chrom, start, end), counted per strand.

Blocks, gaps and fragments on a chromosome the map does not hold count
nowhere but the fragments per reference.
"""

from __future__ import annotations

import numpy as np

from ..frozen import semantics as S
from .decode import Decoded


def _chrom_key(chrom: np.ndarray, coord: np.ndarray) -> np.ndarray:
    return (np.asarray(chrom, np.int64) << 32) | np.asarray(coord, np.int64)


def _seg_chrom(seg: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(seg.size - 1, dtype=np.int64), np.diff(seg))


def mbs_rank(ref, chrom: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Included bases on ``chrom`` strictly before ``pos``, as a global MBS
    index (``chrom`` >= 0)."""
    key = _chrom_key(_seg_chrom(ref.uspan_seg), ref.uspan_start)
    j = np.searchsorted(key, _chrom_key(chrom, pos), side="right") - 1
    first = ref.uspan_seg[chrom].astype(np.int64)
    jc = np.maximum(j, 0)
    length = (ref.uspan_end[jc] - ref.uspan_start[jc]).astype(np.int64)
    inside = ref.uspan_mbs_off[jc] + np.clip(pos - ref.uspan_start[jc], 0, length)
    return np.where(j < first, ref.uspan_mbs_off[np.minimum(first, ref.uspan_start.size)], inside)


def _strand_diff_cumsum(n: int, strand, lo, hi, dtype) -> np.ndarray:
    """(2, n) counts of the half-open index ranges [lo, hi) per strand: +1
    at each start, -1 at each end, summed up in ``dtype``."""
    out = np.empty((2, n), dtype)
    for s in (0, 1):
        m = strand == s
        diff = np.zeros(n + 1, dtype)
        np.add.at(diff, lo[m], 1)
        np.add.at(diff, hi[m], -1)
        np.cumsum(diff[:n], out=out[s])
    return out


def count(ref, d: Decoded) -> dict:
    """The sample's counters: depth (2, mbs) int32, span_hits (2, P), roi_cnt
    (2, R), chr_frag (per BAM reference), n_frags, and the junction tally
    (keys (n, 3) sorted by chrom, start, end; vals (n, 2) fwd, rev)."""
    ok = d.blk_chrom >= 0
    c, s, e, st = d.blk_chrom[ok], d.blk_start[ok], d.blk_end[ok], d.blk_strand[ok]
    lo, hi = mbs_rank(ref, c, s), mbs_rank(ref, c, e)
    depth = _strand_diff_cumsum(ref.mbs_size, st, lo, hi, np.int32)

    OH = S.SPANS_OVERHANG
    sp = e - s >= 2 * OH
    pkey = _chrom_key(_seg_chrom(ref.point_seg), ref.point_coord)
    plo = np.searchsorted(pkey, _chrom_key(c[sp], s[sp] + OH), side="left")
    phi = np.searchsorted(pkey, _chrom_key(c[sp], e[sp] - OH), side="right")
    span_hits = _strand_diff_cumsum(ref.point_coord.size, st[sp], plo, phi, np.int64)

    n_roi = len(ref.roi_names)
    roi_cnt = np.zeros((2, n_roi), np.int64)
    roi_chrom = _seg_chrom(ref.roi_seg)
    fok = d.frag_chrom >= 0
    for r in range(n_roi):
        hit = fok & (d.frag_chrom == roi_chrom[r]) & (ref.roi_start[r] < d.frag_end) \
            & (d.frag_start < ref.roi_end[r])
        roi_cnt[:, r] = np.bincount(d.frag_strand[hit], minlength=2)[:2]

    counted = d.frag_refid >= 0
    chr_frag = np.bincount(d.frag_refid[counted], minlength=len(d.ref_names))

    gok = d.gap_chrom >= 0
    gc, gs, ge, gst = d.gap_chrom[gok], d.gap_start[gok], d.gap_end[gok], d.gap_strand[gok]
    k1 = _chrom_key(gc, gs)
    order = np.lexsort((ge, k1))
    k1, k2 = k1[order], ge[order]
    new = np.ones(k1.size, bool)
    new[1:] = (k1[1:] != k1[:-1]) | (k2[1:] != k2[:-1])
    keys = np.stack([k1[new] >> 32, k1[new] & 0xFFFFFFFF, k2[new]], axis=1)
    row = np.cumsum(new) - 1
    vals = np.bincount(2 * row + gst[order], minlength=2 * keys.shape[0]).reshape(-1, 2)

    return {
        "depth": depth, "span_hits": span_hits, "roi_cnt": roi_cnt,
        "chr_frag": chr_frag, "n_frags": int(counted.sum()),
        "junc_keys": keys, "junc_vals": vals,
    }


def _add(table_size: int, idx: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """(2, table_size): each strand's ``vals`` summed at ``idx``."""
    return np.stack([np.bincount(idx, weights=vals[:, s], minlength=table_size)
                     for s in (0, 1)]).astype(np.int64)


def junction_counters(ref, keys: np.ndarray, vals: np.ndarray) -> tuple:
    """Strand-resolved counts of the tallied junctions that match each unique
    intron start, end and (start, end) pair of the map: (start_cnt,
    end_cnt, exact_cnt), each (2, table)."""
    q = keys.astype(np.int64)
    out = []
    for seg, coord, col in ((ref.bstart_seg, ref.bstart_coord, 1), (ref.bend_seg, ref.bend_coord, 2)):
        table = _chrom_key(_seg_chrom(seg), coord)
        query = _chrom_key(q[:, 0], q[:, col])
        if not (table.size and query.size):
            out.append(np.zeros((2, table.size), np.int64))
            continue
        j = np.minimum(np.searchsorted(table, query), table.size - 1)
        hit = table[j] == query
        out.append(_add(table.size, j[hit], vals[hit]))
    # exact pairs: (chrom, start) and end compared whole, in one merged order
    pk1 = _chrom_key(_seg_chrom(ref.upair_seg), ref.upair_start)
    pk2 = ref.upair_end.astype(np.int64)
    P = pk1.size
    if not (P and q.size):
        return out[0], out[1], np.zeros((2, P), np.int64)
    qk1, qk2 = _chrom_key(q[:, 0], q[:, 1]), q[:, 2]
    # stable: a pair comes before a query with equal keys
    idx = np.lexsort((np.concatenate([pk2, qk2]), np.concatenate([pk1, qk1])))
    is_pair = idx < P
    last = np.maximum.accumulate(np.where(is_pair, idx, -1))
    qpos = np.empty(q.shape[0], np.int64)
    qpos[idx[~is_pair] - P] = last[~is_pair]
    cand = np.maximum(qpos, 0)
    hit = (qpos >= 0) & (pk1[cand] == qk1) & (pk2[cand] == qk2)
    return out[0], out[1], _add(P, cand[hit], vals[hit])
