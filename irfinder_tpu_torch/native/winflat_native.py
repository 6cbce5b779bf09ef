"""ctypes binding for the native Audic-Claverie test (csrc/host/winflat.cpp)."""

from __future__ import annotations

import ctypes

import numpy as np

from . import ensure_built

_lib = None


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built("winflat")
    lib = ctypes.CDLL(path)
    lib.wf_pvalue.restype = ctypes.c_double
    lib.wf_pvalue.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_double, ctypes.c_double]
    lib.wf_pvalues.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
    ]
    _lib = lib
    return lib


def pvalues(x, y, nx, ny) -> np.ndarray:
    """Vectorized two-sided A-C p-values (one native call for all rows)."""
    lib = load_library()
    x = np.ascontiguousarray(x, dtype=np.int64)
    y = np.ascontiguousarray(y, dtype=np.int64)
    nx = np.ascontiguousarray(nx, dtype=np.float64)
    ny = np.ascontiguousarray(ny, dtype=np.float64)
    out = np.zeros(len(x), dtype=np.float64)
    I64P = ctypes.POINTER(ctypes.c_int64)
    F64P = ctypes.POINTER(ctypes.c_double)
    lib.wf_pvalues(
        x.ctypes.data_as(I64P), y.ctypes.data_as(I64P),
        nx.ctypes.data_as(F64P), ny.ctypes.data_as(F64P),
        out.ctypes.data_as(F64P), len(x),
    )
    return out
