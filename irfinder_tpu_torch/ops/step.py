"""The per-batch counting step (port of irfinder_tpu/ops/step.py).

Counters live in one flat int32 array ``cnt`` with the JAX package's layout
(CounterLayout, same offsets, same TILE padding), plus the small per-refid
array ``chr``.  The port updates both in place: the step returns nothing and
the caller keeps its tensors.

* ``count_step`` runs the whole step: on CUDA counters, one launch of the
  hand-written kernel kernels.count_step (csrc/count.cu); on CPU ones, the
  plain version ``count_step_plain``.
* ``count_step_plain`` is CoverageBlocks + SpansPoint (``count_blocks_plain``,
  the plain composition of the two TPU kernels), then FragmentsInChr,
  FragmentsInROI and the fragment total as plain torch ops, as the JAX
  package leaves them to plain XLA ops.

Everything is integer and add-associative, so counters are invariant under
batch order and batch size.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from .. import semantics as S
from .device_ref import DeviceRef
from .prefix import cumsum_last
from .rank import block_ranks
from .scatter import pad_len, scatter_add

#: the SpansPoint overhang: a block must cover a point by this many bases
OVERHANG = int(S.SPANS_OVERHANG)


@dataclasses.dataclass(frozen=True)
class CounterLayout:
    """Static offsets of each counter section inside the flat cnt array.

    Sections (all int32):
      dd   (2, mbs+1)      depth diff over MBS, per strand     [cumsum later]
      p    (2, P+1)        spans diff over boundary points     [cumsum later]
      roi  (2, R+1)        fragments per ROI, per strand
      nf   (1,)            admitted fragments
      pad  (...)           zeros up to a TILE multiple (ops/scatter.py)
    """

    mbs: int
    P: int
    R: int

    @staticmethod
    def build(dref: DeviceRef) -> "CounterLayout":
        return CounterLayout(mbs=dref.mbs_size, P=dref.P, R=dref.R)

    @property
    def w_dd(self):
        return self.mbs + 1

    @property
    def w_p(self):
        return self.P + 1

    @property
    def off_dd(self):
        return 0

    @property
    def off_p(self):
        return self.off_dd + 2 * (self.mbs + 1)

    @property
    def off_roi(self):
        return self.off_p + 2 * (self.P + 1)

    @property
    def off_nf(self):
        return self.off_roi + 2 * (self.R + 1)

    @property
    def total(self):
        return pad_len(self.off_nf + 1)


def init_counters(dref: DeviceRef, n_refids: int) -> dict:
    """Zeroed counters on the DeviceRef's device; ``n_refids`` is the BAM
    header's reference count."""
    lay = CounterLayout.build(dref)
    return {
        "cnt": torch.zeros(lay.total, dtype=torch.int32, device=dref.device),
        "chr": torch.zeros(n_refids + 1, dtype=torch.int32, device=dref.device),
    }


def count_blocks_plain(dref, cnt, blk_chrom, blk_start, blk_end, blk_strand, lay, overhang: int) -> None:
    """The block half of count_step_plain: block_ranks + scatter_add composed
    as the reference step composes the TPU kernels."""
    lo, hi, spans = block_ranks(dref, blk_chrom, blk_start, blk_end, blk_strand, overhang, lay.P)
    dd_base = lay.off_dd + blk_strand.to(torch.int64) * lay.w_dd
    ones = torch.ones_like(blk_chrom)
    scatter_add(cnt, torch.cat([dd_base + lo, dd_base + hi]), torch.cat([ones, -ones]))
    cnt[lay.off_p : lay.off_p + 2 * lay.w_p] += spans


def count_step(dref: DeviceRef, counters: dict, batch: dict) -> None:
    """One batch (the unpack_fused column dict) through every counter, in
    place: one launch of the CUDA kernel for CUDA counters, the plain version
    for CPU ones."""
    lay = CounterLayout.build(dref)
    fn = kernels.count_step if counters["cnt"].is_cuda else count_step_plain
    fn(dref, counters, batch, lay, OVERHANG)


def count_step_plain(dref: DeviceRef, counters: dict, batch: dict, lay, overhang: int) -> None:
    """The plain version of kernels.count_step: count_blocks_plain, then the
    fragment tallies as the JAX step computes them with plain XLA ops."""
    cnt = counters["cnt"]
    count_blocks_plain(
        dref, cnt, batch["blk_chrom"], batch["blk_start"], batch["blk_end"],
        batch["blk_strand"], lay, overhang,
    )

    # --- FragmentsInChr: per BAM refid; pads and unknown ids -> trash slot --
    f_rid = batch["frag_refid"]
    chrn = counters["chr"]
    n_refids = chrn.shape[0] - 1
    rid = torch.where((f_rid >= 0) & (f_rid < n_refids), f_rid, n_refids)
    chrn.index_add_(0, rid, torch.ones_like(rid))

    # --- FragmentsInROI: dense broadcast overlap (tiny table) ---------------
    f_c, f_s, f_e = batch["frag_chrom"], batch["frag_start"], batch["frag_end"]
    f_st = batch["frag_strand"]
    overlap = (
        (f_c[:, None] == dref.roi_chrom[None, :-1])
        & (dref.roi_start[None, :-1] < f_e[:, None])
        & (f_s[:, None] < dref.roi_end[None, :-1])
    )
    R = lay.R
    cnt[lay.off_roi : lay.off_roi + R] += (overlap & (f_st == 0)[:, None]).sum(0, dtype=torch.int32)
    cnt[lay.off_roi + R + 1 : lay.off_roi + 2 * R + 1] += (overlap & (f_st == 1)[:, None]).sum(
        0, dtype=torch.int32
    )

    # --- fragment total -----------------------------------------------------
    cnt[lay.off_nf : lay.off_nf + 1] += (f_rid >= 0).sum(dtype=torch.int32)


def depth_rows(dd: torch.Tensor) -> torch.Tensor:
    """The (2, mbs) depth from the (2, mbs+1) depth-diff rows: each row's
    int32 cumsum, written into a buffer whose row stride is mbs+1 rounded up
    to a multiple of kernels.ROW_ALIGN (8) words, returned as the [:, :mbs]
    view.  Both rows then start 32-byte aligned, as kernels.intron_stats
    reads them (in aligned 8-word groups, through the padding)."""
    w = dd.shape[1]
    buf = _row_buffer(w, dd.device)
    for k in (0, 1):
        torch.cumsum(dd[k], 0, dtype=torch.int32, out=buf[k, :w])
    return buf[:, : w - 1]


def _row_buffer(w: int, device) -> torch.Tensor:
    """An uninitialised (2, w rounded up to kernels.ROW_ALIGN) int32 buffer."""
    a = kernels.ROW_ALIGN
    return torch.empty((2, -(-w // a) * a), dtype=torch.int32, device=device)


def depth_on_device(depth, device) -> torch.Tensor:
    """A host (2, mbs) depth (numpy) on ``device``, in depth_rows' padded
    layout, which kernels.intron_stats reads: one copy per row."""
    mbs = depth.shape[1]
    buf = _row_buffer(mbs + 1, device)
    for k in (0, 1):
        buf[k, :mbs].copy_(torch.from_numpy(np.ascontiguousarray(depth[k], np.int32)))
    return buf[:, :mbs]


def finalize_device(dref: DeviceRef, counters: dict) -> dict:
    """Flat cnt -> named dense counters (diff sections cumsummed, trash slots
    dropped).  The depth's rows are padded (depth_rows)."""
    lay = CounterLayout.build(dref)
    cnt = counters["cnt"]

    def sect2(off, w):
        return cnt[off : off + 2 * w].view(2, w)

    return {
        "depth": depth_rows(sect2(lay.off_dd, lay.w_dd)),
        "span_hits": cumsum_last(sect2(lay.off_p, lay.w_p))[:, :-1],
        "roi_cnt": sect2(lay.off_roi, lay.R + 1)[:, :-1],
        "chr_frag": counters["chr"][:-1],
        "n_frags": cnt[lay.off_nf],
    }
