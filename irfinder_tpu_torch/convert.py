"""Carry the JAX package's device state into the port.

Both take numpy arrays (``np.asarray`` of the JAX arrays), so this module
imports no JAX.  The flat counter layout is index-identical in both packages
(ops/step.py CounterLayout), so counters taken from a JAX run continue in the
port unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.device_ref import COLUMNS, DeviceRef, from_columns


def device_ref_from_numpy(cols: dict, device="cpu") -> DeviceRef:
    """The JAX DeviceRef's columns (``uspan_chrom/start/len/off``,
    ``chrom_base``, ``point_chrom/coord``, ``roi_*`` and
    ``mbs_size_static``) -> the port's DeviceRef on ``device``."""
    return from_columns({k: cols[k] for k in COLUMNS}, device)


def counters_from_numpy(counters: dict, device="cpu") -> dict:
    """JAX counters ``{"cnt", "chr"}`` -> the port's int32 counter tensors."""
    out = {}
    for k in ("cnt", "chr"):
        a = np.asarray(counters[k])
        if a.dtype != np.int32 or a.ndim != 1:
            raise TypeError(f"counters[{k!r}]: expected 1-D int32, got {a.dtype} {a.shape}")
        out[k] = torch.from_numpy(a.copy()).to(device)
    return out
