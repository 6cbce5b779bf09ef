"""ctypes binding for the bulk table formatter (csrc/host/tabfmt.cpp).

format_table(cols) renders a whole tab-separated table in one GIL-released
C call.  Column kinds:

    ("i", arr)            int64-castable integer array
    ("g", arr)            float64 array, C printf %g (== Python f"{v:g}")
    ("s", idx, strings)   per-row int32 index into a list of strings, or
                          into a StringPool made once from such a list

A table of more than ROWS_PER_CHUNK rows renders in row chunks, one thread
each, as many as the process may use cores (chunk_count); the bytes are the
same for any chunk count.

The Python per-line writers in format.py remain the formatting spec, and
every caller falls back to them when the library is unavailable.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from . import ensure_built

#: rows a chunk should hold at least: a table renders in
#: min(usable cores, ceil(rows / ROWS_PER_CHUNK)) chunks
ROWS_PER_CHUNK = 16384

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
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
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


class StringPool:
    """A list of strings as the formatter reads it: one blob of their UTF-8
    bytes and int64 offsets (string i spans ``off[i]:off[i + 1]``).  Made
    once for a list that many renders share, such as a map's intron names."""

    __slots__ = ("blob", "off")

    def __init__(self, strings):
        enc = [s.encode() for s in strings]
        self.blob = b"".join(enc)
        self.off = np.zeros(len(enc) + 1, dtype=np.int64)
        np.cumsum(np.fromiter(map(len, enc), dtype=np.int64, count=len(enc)), out=self.off[1:])

    def __len__(self) -> int:
        return int(self.off.size) - 1


def usable_cores() -> int:
    """The cores this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # no affinity call on this platform
        return os.cpu_count() or 1


def chunk_count(n_rows: int) -> int:
    """The row chunks a table of ``n_rows`` renders in: one below
    ROWS_PER_CHUNK rows, never more than the usable cores."""
    return max(1, min(usable_cores(), -(-n_rows // ROWS_PER_CHUNK)))


def format_table(cols, n_rows: int | None = None) -> bytes:
    """Render the table described by `cols` (see module docstring) to bytes.
    Raises RuntimeError when the native library cannot be built."""
    lib = load_library()
    col_types = []
    keep = []  # keep arrays and pools alive for the duration of the call
    ptrs, blobs, offs, pool_ns = [], [], [], []
    for col in cols:
        kind = col[0]
        blob = off = None
        n_pool = 0
        if kind == "i":
            a = np.ascontiguousarray(np.asarray(col[1], dtype=np.int64))
            col_types.append(0)
        elif kind == "g":
            a = np.ascontiguousarray(np.asarray(col[1], dtype=np.float64))
            col_types.append(1)
        elif kind == "s":
            a = np.ascontiguousarray(np.asarray(col[1], dtype=np.int32))
            pool = col[2] if isinstance(col[2], StringPool) else StringPool(col[2])
            keep.append(pool)
            blob = ctypes.cast(ctypes.c_char_p(pool.blob), ctypes.c_void_p).value
            off, n_pool = pool.off.ctypes.data, len(pool)
            col_types.append(2)
        else:
            raise ValueError(f"unknown column kind {kind!r}")
        if n_rows is None:
            n_rows = int(a.shape[0])
        elif a.shape[0] != n_rows:
            raise ValueError("column length mismatch")
        keep.append(a)
        ptrs.append(a.ctypes.data)
        blobs.append(blob)
        offs.append(off)
        pool_ns.append(n_pool)
    if n_rows is None:
        n_rows = 0
    k = chunk_count(n_rows)
    n_cols = len(cols)
    out_len = ctypes.c_int64(0)
    p = lib.tf_format(
        n_rows, n_cols,
        (ctypes.c_int32 * n_cols)(*col_types),
        (ctypes.c_void_p * n_cols)(*ptrs),
        (ctypes.c_void_p * n_cols)(*blobs),
        (ctypes.c_void_p * n_cols)(*offs),
        (ctypes.c_int64 * n_cols)(*pool_ns),
        k, ctypes.byref(out_len),
    )
    if not p:
        raise RuntimeError("tf_format failed (allocation or pool index)")
    try:
        return ctypes.string_at(p, out_len.value)
    finally:
        lib.tf_free(p)
