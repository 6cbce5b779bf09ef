"""Carry the JAX package's reference and device state into the port.

Every function takes numpy arrays and plain Python values (``np.asarray`` of
the JAX arrays, the fields of the JAX package's CompiledRef), so this module
imports nothing of the JAX package.  The flat counter layout is
index-identical in both packages (ops/step.py CounterLayout), so counters
taken from a JAX run continue in the port unchanged.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.device_ref import COLUMNS, DeviceRef, from_columns
from .refio.compile import CompiledRef

#: the CompiledRef fields that hold lists of strings, not arrays
_LIST_FIELDS = ("chroms", "intron_names", "roi_names")


def compiled_ref_from_numpy(fields: dict) -> CompiledRef:
    """The JAX package's CompiledRef fields (``{f.name: getattr(ref, f.name)}``
    over its dataclass fields) -> the port's CompiledRef.  Arrays are copied
    with their dtypes; a missing or unknown field raises."""
    names = [f.name for f in dataclasses.fields(CompiledRef)]
    missing = sorted(set(names) - set(fields))
    extra = sorted(set(fields) - set(names))
    if missing or extra:
        raise KeyError(f"CompiledRef fields: missing {missing}, unknown {extra}")
    kw = {}
    for k in names:
        v = fields[k]
        kw[k] = [str(x) for x in v] if k in _LIST_FIELDS else np.array(v, copy=True)
    return CompiledRef(**kw)


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
