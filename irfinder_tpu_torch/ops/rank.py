"""Block ranks — the plain PyTorch version of the TPU rank kernel.

Port of what irfinder_tpu/ops/pallas_rank.py:block_ranks_pallas computes
(not how: its int8 planes and one-hot MXU gathers are TPU workarounds).  On
the card this work is done by the fused kernel csrc/count.cu, which
ops/step.py:count_blocks_plain composes this function into.
"""

from __future__ import annotations

import torch

from .device_ref import DeviceRef, make_key, mbs_rank


def block_ranks(dref: DeviceRef, blk_chrom, blk_start, blk_end, blk_strand, overhang: int, P: int):
    """MBS ranks of both block edges plus the batch's SpansPoint diff.

    Returns (lo, hi, spans): lo/hi int32 (B,) MBS ranks of blk_start/blk_end
    (pad lanes rank at mbs, which the caller may mask further);
    spans int32 (2*(P+1),) with +1 at plo = #points < (chrom, start+OH) and
    -1 at phi = #points <= (chrom, end-OH) on row blk_strand, misses (chrom
    < 0, or a block shorter than 2*OH) at trash slot P."""
    lo = mbs_rank(dref, blk_chrom, blk_start)
    hi = mbs_rank(dref, blk_chrom, blk_end)
    # int32 arithmetic, as the reference step does it
    q_lo = make_key(blk_chrom, blk_start + overhang)
    q_hi = make_key(blk_chrom, blk_end - overhang)
    plo = torch.searchsorted(dref.point_key, q_lo, side="left")
    phi = torch.searchsorted(dref.point_key, q_hi, side="right")
    ok = (blk_chrom >= 0) & (blk_end - blk_start >= 2 * overhang)
    plo = torch.where(ok, plo, P)
    phi = torch.where(ok, phi, P)
    row = blk_strand.to(torch.int64) * (P + 1)
    spans = torch.zeros(2 * (P + 1), dtype=torch.int32, device=blk_chrom.device)
    ones = torch.ones_like(blk_chrom)
    spans.index_add_(0, row + plo, ones)
    spans.index_add_(0, row + phi, -ones)
    return lo, hi, spans
