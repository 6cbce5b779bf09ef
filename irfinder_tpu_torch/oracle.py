"""NumPy conformance oracle, the port's copy of irfinder_tpu/oracle.py: the
executable specification of the counting semantics, in Python beside the C++
one (csrc/host/oracle.cpp).

A deliberately straightforward reimplementation of the reference's counting
stage over PackedBatches.  The device step (ops/step.py, csrc/count.cu) must
agree with this module bit-exactly; tests hold both to it.  Keep this code
simple and obviously-correct — it is the arbiter, not the fast path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import semantics as S
from .refio.compile import CompiledRef
from .io.batch import PackedBatch


def mbs_rank(ref: CompiledRef, chrom: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Vectorized measured-base-space rank: number of included bases on
    `chrom` strictly before `pos` (the global MBS index of pos when included).
    chrom == -1 lanes return the trash index (mbs_size)."""
    chrom = np.asarray(chrom)
    pos = np.asarray(pos)
    out = np.empty(pos.shape, dtype=np.int64)
    for i in np.ndindex(pos.shape):
        c = int(chrom[i])
        if c < 0:
            out[i] = ref.mbs_size
            continue
        a, b = int(ref.uspan_seg[c]), int(ref.uspan_seg[c + 1])
        k = int(np.searchsorted(ref.uspan_start[a:b], pos[i], side="right")) - 1 + a
        if k < a:
            out[i] = int(ref.uspan_mbs_off[a])
        else:
            length = int(ref.uspan_end[k] - ref.uspan_start[k])
            out[i] = int(ref.uspan_mbs_off[k]) + min(
                max(int(pos[i]) - int(ref.uspan_start[k]), 0), length
            )
    return out


@dataclasses.dataclass
class OracleCounters:
    """Additive integer counters; strand axis 0 = fragment strand 0 (fwd),
    1 = fragment strand 1 (rev)."""

    ref: CompiledRef
    depth: np.ndarray  # int64 (2, mbs_size) per-base depth
    start_cnt: np.ndarray  # int64 (2, S) gaps matching unique intron starts
    end_cnt: np.ndarray  # int64 (2, E)
    exact_cnt: np.ndarray  # int64 (2, X)
    span_hits: np.ndarray  # int64 (2, P) blocks spanning each boundary point
    roi_cnt: np.ndarray  # int64 (2, R)
    chr_frag: dict  # {bam_refid: fragments}
    n_frags: int = 0

    @classmethod
    def create(cls, ref: CompiledRef) -> "OracleCounters":
        return cls(
            ref=ref,
            depth=np.zeros((2, ref.mbs_size), dtype=np.int64),
            start_cnt=np.zeros((2, ref.bstart_coord.size), dtype=np.int64),
            end_cnt=np.zeros((2, ref.bend_coord.size), dtype=np.int64),
            exact_cnt=np.zeros((2, ref.upair_start.size), dtype=np.int64),
            span_hits=np.zeros((2, ref.point_coord.size), dtype=np.int64),
            roi_cnt=np.zeros((2, len(ref.roi_names)), dtype=np.int64),
            chr_frag={},
        )

    # -- accumulation --------------------------------------------------------
    def add_batch(self, b: PackedBatch) -> None:
        ref = self.ref
        # 1) coverage depth: +1 over each block's included bases
        for i in range(b.n_blocks):
            c = int(b.blk_chrom[i])
            if c < 0:
                continue
            st = int(b.blk_strand[i])
            lo = mbs_rank(ref, np.array([c]), np.array([b.blk_start[i]]))[0]
            hi = mbs_rank(ref, np.array([c]), np.array([b.blk_end[i]]))[0]
            self.depth[st, lo:hi] += 1
        # 2) junction gap boundary matching (exact coordinate equality)
        for i in range(b.n_gaps):
            c = int(b.gap_chrom[i])
            if c < 0:
                continue
            st = int(b.gap_strand[i])
            gs, ge = int(b.gap_start[i]), int(b.gap_end[i])
            a, z = int(ref.bstart_seg[c]), int(ref.bstart_seg[c + 1])
            k = int(np.searchsorted(ref.bstart_coord[a:z], gs)) + a
            if k < z and ref.bstart_coord[k] == gs:
                self.start_cnt[st, k] += 1
            a, z = int(ref.bend_seg[c]), int(ref.bend_seg[c + 1])
            k = int(np.searchsorted(ref.bend_coord[a:z], ge)) + a
            if k < z and ref.bend_coord[k] == ge:
                self.end_cnt[st, k] += 1
            a, z = int(ref.upair_seg[c]), int(ref.upair_seg[c + 1])
            # pairs sorted by (start, end) within chrom
            k = int(
                np.searchsorted(
                    ref.upair_start[a:z].astype(np.int64) << 32
                    | ref.upair_end[a:z].astype(np.int64),
                    (gs << 32) | ge,
                )
            ) + a
            if k < z and ref.upair_start[k] == gs and ref.upair_end[k] == ge:
                self.exact_cnt[st, k] += 1
        # 3) spans-point: block [s,e) spans point p iff s+OH <= p <= e-OH
        OH = S.SPANS_OVERHANG
        for i in range(b.n_blocks):
            c = int(b.blk_chrom[i])
            if c < 0:
                continue
            st = int(b.blk_strand[i])
            s, e = int(b.blk_start[i]), int(b.blk_end[i])
            if e - s < 2 * OH:
                continue
            a, z = int(ref.point_seg[c]), int(ref.point_seg[c + 1])
            lo = int(np.searchsorted(ref.point_coord[a:z], s + OH, side="left")) + a
            hi = int(np.searchsorted(ref.point_coord[a:z], e - OH, side="right")) + a
            self.span_hits[st, lo:hi] += 1
        # 4) ROI fragment overlap + per-chrom fragment tallies
        for i in range(b.n_frags):
            rid = int(b.frag_refid[i])
            if rid < 0:
                continue
            self.n_frags += 1
            self.chr_frag[rid] = self.chr_frag.get(rid, 0) + 1
            c = int(b.frag_chrom[i])
            if c < 0:
                continue
            st = int(b.frag_strand[i])
            fs, fe = int(b.frag_start[i]), int(b.frag_end[i])
            a, z = int(ref.roi_seg[c]), int(ref.roi_seg[c + 1])
            for r in range(a, z):
                if ref.roi_start[r] < fe and fs < ref.roi_end[r]:
                    self.roi_cnt[st, r] += 1

    # -- merge (multi-shard determinism model) --------------------------------
    def merge(self, other: "OracleCounters") -> None:
        self.depth += other.depth
        self.start_cnt += other.start_cnt
        self.end_cnt += other.end_cnt
        self.exact_cnt += other.exact_cnt
        self.span_hits += other.span_hits
        self.roi_cnt += other.roi_cnt
        self.n_frags += other.n_frags
        for k, v in other.chr_frag.items():
            self.chr_frag[k] = self.chr_frag.get(k, 0) + v


def intron_rows(
    counters: OracleCounters,
    mode: str = "nondir",
    flip_strand: bool = False,
) -> list:
    """Finalize counters into IntronRow records via the shared row math in
    finalize.py (one code path for oracle and engine)."""
    from .finalize import intron_table

    return intron_table(
        counters.ref,
        counters.depth,
        counters.start_cnt,
        counters.end_cnt,
        counters.exact_cnt,
        counters.span_hits,
        mode=mode,
        flip_strand=flip_strand,
    ).rows()
