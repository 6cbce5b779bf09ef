"""PackedBatch: the columnar host->device read-batch contract.

This is the engine's analog of the reference's per-fragment FragmentBlocks
callback unit (SURVEY.md §2 rows 7-9): instead of streaming one fragment at a
time through a processor chain, the decoder flattens many fragments into
fixed-capacity, statically-shaped column arrays (BASELINE.json:5 "packed
(chrom, start, CIGAR-span, splice-gap) tensors") that one jitted device step
consumes.  Padding lanes carry chrom == -1 and are routed to a trash slot by
the device kernels, so padded work provably contributes zero (SURVEY.md §7.3
item 5).

Both the pure-Python decoder (io/bampy.py) and the native C++ decoder
(csrc/host/bamdecode.cpp) emit exactly this layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Batch column capacities as multiples of cap_frags.  A paired-end
#: fragment is typically 2 blocks (one per mate) and <1 splice gap; both
#: decoders emit a batch early when any column fills, so these ratios only
#: trade padding waste (device work on dead lanes) against batch count.
BLOCKS_PER_FRAG = 3
GAPS_PER_FRAG = 1
#: Long-read batch geometry (--long-reads): full-length transcript
#: alignments (ONT/PacBio) carry one block per exon — tens of blocks and
#: gaps per fragment, single-end.  With the paired-end ratios above such a
#: stream flushes batches on the block column at ~cap_frags/20 fragments,
#: leaving the frag columns ~95% padding; these ratios rebalance the fixed
#: shapes.  Counting semantics are identical under any geometry (batches
#: are add-associative) — this is purely a padding/throughput knob.
LONGREAD_BLOCKS_PER_FRAG = 64
LONGREAD_GAPS_PER_FRAG = 64
#: Floor on the block/gap column capacities, independent of cap_frags: one
#: fragment must always fit a single batch (mate carry-over, SURVEY.md §7.3
#: item 4).  4096 aligned blocks per fragment covers any real alignment
#: (long-read spliced alignments run ~10^2 exon blocks); beyond it the
#: decoders raise instead of silently truncating.
MIN_CAP_UNITS = 4096


@dataclasses.dataclass
class PackedBatch:
    # aligned contiguous blocks (one per CIGAR run of M/D/=/X per mate)
    blk_chrom: np.ndarray  # int32 (B,)  compiled chrom id, -1 = pad/unknown
    blk_start: np.ndarray  # int32 (B,)
    blk_end: np.ndarray  # int32 (B,)
    blk_strand: np.ndarray  # int32 (B,)  fragment strand 0/1
    # splice gaps (one per N CIGAR op per mate)
    gap_chrom: np.ndarray  # int32 (G,)
    gap_start: np.ndarray  # int32 (G,)
    gap_end: np.ndarray  # int32 (G,)
    gap_strand: np.ndarray  # int32 (G,)
    # fragment spans (for ROI / per-chrom tallies)
    frag_chrom: np.ndarray  # int32 (F,)  compiled chrom id, -1 = pad/unknown
    frag_refid: np.ndarray  # int32 (F,)  BAM-space ref id, -1 = pad
    frag_start: np.ndarray  # int32 (F,)
    frag_end: np.ndarray  # int32 (F,)
    frag_strand: np.ndarray  # int32 (F,)
    frag_nblk: np.ndarray  # int32 (F,) blocks emitted for this frag row
    # scalars (host-side metrics; not shipped to device)
    n_blocks: int = 0
    n_gaps: int = 0
    n_frags: int = 0
    n_reads: int = 0  # admitted reads folded into this batch
    # one contiguous int32 buffer backing the 9 device-bound columns (the blk
    # and frag columns are views into it): one host-to-device copy per batch
    _fused: np.ndarray | None = None
    # False for a batch whose block/frag columns were never filled (the JAX
    # package's wire-only decoder batches): the engine refuses it instead of
    # shipping zero columns.  The port's decoders always fill every column.
    columns_full: bool = True
    # opaque decoder-state token (shared format between the native and Python
    # decoders, see io/bampy.py): re-opening the BAM with this token
    # reproduces the stream after this batch, the checkpoint/resume seek
    resume_token: bytes | None = None

    @staticmethod
    def empty(cap_blocks: int, cap_gaps: int, cap_frags: int) -> "PackedBatch":
        z = lambda n: np.zeros(n, dtype=np.int32)
        m = lambda n: np.full(n, -1, dtype=np.int32)
        fused = np.zeros(4 * cap_blocks + 5 * cap_frags, dtype=np.int32)
        bc = fused[0:cap_blocks]
        bc.fill(-1)
        o = 4 * cap_blocks
        fc = fused[o : o + cap_frags]
        fc.fill(-1)
        fr = fused[o + cap_frags : o + 2 * cap_frags]
        fr.fill(-1)
        return PackedBatch(
            blk_chrom=bc,
            blk_start=fused[cap_blocks : 2 * cap_blocks],
            blk_end=fused[2 * cap_blocks : 3 * cap_blocks],
            blk_strand=fused[3 * cap_blocks : 4 * cap_blocks],
            gap_chrom=m(cap_gaps),
            gap_start=z(cap_gaps),
            gap_end=z(cap_gaps),
            gap_strand=z(cap_gaps),
            frag_chrom=fc,
            frag_refid=fr,
            frag_start=fused[o + 2 * cap_frags : o + 3 * cap_frags],
            frag_end=fused[o + 3 * cap_frags : o + 4 * cap_frags],
            frag_strand=fused[o + 4 * cap_frags : o + 5 * cap_frags],
            frag_nblk=z(cap_frags),
            _fused=fused,
        )

    @property
    def cap_blocks(self) -> int:
        return int(self.blk_chrom.shape[0])

    @property
    def cap_frags(self) -> int:
        return int(self.frag_chrom.shape[0])

    def fused_h2d(self) -> np.ndarray:
        """The single int32 buffer shipped to the device step: 4 blk columns
        of cap_blocks then 5 frag columns of cap_frags (unpack_fused below is
        the device-side inverse).  Zero-copy when the batch was built by
        PackedBatch.empty; assembled once otherwise."""
        if self._fused is not None:
            return self._fused
        return np.concatenate(
            [
                self.blk_chrom, self.blk_start, self.blk_end, self.blk_strand,
                self.frag_chrom, self.frag_refid, self.frag_start,
                self.frag_end, self.frag_strand,
            ]
        )

    def device_arrays(self) -> dict:
        """The columns the device step reads (order-stable dict).  Gap
        columns are not shipped: junction counting lives on the host tally
        (junctions.JuncTally), so gaps never cross to the device."""
        return {
            "blk_chrom": self.blk_chrom,
            "blk_start": self.blk_start,
            "blk_end": self.blk_end,
            "blk_strand": self.blk_strand,
            "frag_chrom": self.frag_chrom,
            "frag_refid": self.frag_refid,
            "frag_start": self.frag_start,
            "frag_end": self.frag_end,
            "frag_strand": self.frag_strand,
            "frag_nblk": self.frag_nblk,
        }


def all_arrays_of(b: "PackedBatch") -> dict:
    """Every column including host-only gaps (oracle/conformance paths)."""
    d = b.device_arrays()
    d.update(
        gap_chrom=b.gap_chrom, gap_start=b.gap_start,
        gap_end=b.gap_end, gap_strand=b.gap_strand,
    )
    return d


def unpack_fused(flat, cap_blocks: int, cap_frags: int) -> dict:
    """Device-side inverse of PackedBatch.fused_h2d (torch or numpy): one
    sliced view per column, no data movement."""
    names_b = ("blk_chrom", "blk_start", "blk_end", "blk_strand")
    names_f = ("frag_chrom", "frag_refid", "frag_start", "frag_end", "frag_strand")
    out = {}
    for i, nm in enumerate(names_b):
        out[nm] = flat[i * cap_blocks : (i + 1) * cap_blocks]
    o = 4 * cap_blocks
    for i, nm in enumerate(names_f):
        out[nm] = flat[o + i * cap_frags : o + (i + 1) * cap_frags]
    return out
