"""Scatter-add — the plain PyTorch version of the TPU scatter kernel.

Port of what irfinder_tpu/ops/scatter.py:scatter_add_pallas computes.  Its
sort + one-hot MXU tiling is a TPU workaround; on the card the update is an
integer atomicAdd inside the fused kernel csrc/count.cu.  ``TILE`` and
``pad_len`` stay only so that CounterLayout.total, and with it the flat
counter array, is index-identical to the JAX package's.
"""

from __future__ import annotations

import torch

#: cnt entries per tile of the JAX scatter kernel (the counter padding unit)
TILE = 512 * 128


def pad_len(n: int) -> int:
    """Round a counter array length up to a TILE multiple."""
    return -(-n // TILE) * TILE


def scatter_add(cnt: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """cnt[idx] += val in place (int32); sentinel entries idx >= len(cnt) are
    ignored.  Returns cnt."""
    # a sentinel adds 0 at slot 0 (no boolean indexing: that syncs the card)
    keep = idx < cnt.shape[0]
    return cnt.index_add_(0, torch.where(keep, idx, 0), torch.where(keep, val, 0))
