"""ctypes binding for the bulk table formatter (csrc/host/tabfmt.cpp).

format_table(cols) renders a whole tab-separated table in one GIL-released
C call.  Column kinds:

    ("i", arr)            int64-castable integer array
    ("g", arr)            float64 array, C printf %g (== Python f"{v:g}")
    ("s", idx, strings)   per-row int32 index into a list of strings

The Python per-line writers in format.py remain the formatting spec, and
every caller falls back to them when the library is unavailable.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import ensure_built

_lib = None
_lib_failed = False


def load_library():
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        raise RuntimeError("tabfmt library unavailable (earlier build failure)")
    try:
        path = ensure_built("tabfmt")
        lib = ctypes.CDLL(path)
    except (RuntimeError, OSError) as e:
        _lib_failed = True
        raise RuntimeError(f"tabfmt build failed: {e}") from e
    lib.tf_format.restype = ctypes.c_void_p
    lib.tf_format.argtypes = [
        ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.tf_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        load_library()
        return True
    except RuntimeError:
        return False


def format_table(cols, n_rows: int | None = None) -> bytes:
    """Render the table described by `cols` (see module docstring) to bytes.
    Raises RuntimeError when the native library cannot be built."""
    lib = load_library()
    # assemble one shared string pool across all "s" columns
    pool_strings: list[bytes] = []
    col_types = []
    arrays = []  # keep references alive for the duration of the call
    ptrs = []
    for col in cols:
        kind = col[0]
        if kind == "i":
            a = np.ascontiguousarray(np.asarray(col[1], dtype=np.int64))
            col_types.append(0)
        elif kind == "g":
            a = np.ascontiguousarray(np.asarray(col[1], dtype=np.float64))
            col_types.append(1)
        elif kind == "s":
            idx = np.asarray(col[1], dtype=np.int32)
            base = len(pool_strings)
            pool_strings.extend(s.encode() for s in col[2])
            a = np.ascontiguousarray(idx + base)
            col_types.append(2)
        else:
            raise ValueError(f"unknown column kind {kind!r}")
        if n_rows is None:
            n_rows = int(a.shape[0])
        elif a.shape[0] != n_rows:
            raise ValueError("column length mismatch")
        arrays.append(a)
        ptrs.append(a.ctypes.data_as(ctypes.c_void_p))
    if n_rows is None:
        n_rows = 0
    blob = b"".join(pool_strings)
    off = np.zeros(len(pool_strings) + 1, dtype=np.int64)
    if pool_strings:
        np.cumsum([len(s) for s in pool_strings], out=off[1:])
    out_len = ctypes.c_int64(0)
    types_arr = (ctypes.c_int32 * len(col_types))(*col_types)
    ptr_arr = (ctypes.c_void_p * len(ptrs))(*[p.value for p in ptrs])
    p = lib.tf_format(
        n_rows, len(cols), types_arr, ptr_arr, blob,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(pool_strings),
        ctypes.byref(out_len),
    )
    if not p:
        raise RuntimeError("tf_format failed (allocation or pool index)")
    try:
        return ctypes.string_at(p, out_len.value)
    finally:
        lib.tf_free(p)
