"""Prefix sums over the counter diff sections (port of irfinder_tpu/ops/prefix.py).

The JAX package splits a long cumsum into two levels to cut XLA's passes on
the TPU; that split is a TPU workaround and is not ported.
"""

from __future__ import annotations

import torch


def cumsum_last(x: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumsum along the last axis.  ``dtype`` must be given:
    without it torch.cumsum promotes int32 to int64."""
    return torch.cumsum(x, dim=-1, dtype=torch.int32)
