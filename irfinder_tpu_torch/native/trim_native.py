"""ctypes binding for the native adapter trimmer (csrc/host/trim.cpp), and
the path of its standalone filter program.  Pre-alignment filter of FastQ
``--trim`` only: not on the counting path."""

from __future__ import annotations

import ctypes

from . import ensure_built

#: Illumina TruSeq 3' adapters (R1, R2).
ADAPTER_R1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER_R2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"

_lib = None


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built("trim"))
    lib.tr_trim1.restype = ctypes.c_int
    lib.tr_trim1.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.tr_trim2.restype = None
    lib.tr_trim2.argtypes = [
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


def trim1(read: bytes, adapter: bytes = ADAPTER_R1) -> int:
    """Kept length of a single read after 3' adapter removal."""
    lib = load_library()
    return lib.tr_trim1(read, len(read), adapter, len(adapter))


def trim_binary() -> str:
    """Path to the standalone trim filter program (4-file / interleaved-pipe
    CLI), building it if stale: the FastQ-mode pre-alignment filter."""
    return ensure_built("trim", executable=True)


def trim_pair(
    r1: bytes,
    r2: bytes,
    adapter1: bytes = ADAPTER_R1,
    adapter2: bytes = ADAPTER_R2,
) -> tuple:
    """Kept lengths (k1, k2) after adapter removal + read-through clipping."""
    lib = load_library()
    out = (ctypes.c_int32 * 2)()
    lib.tr_trim2(r1, len(r1), r2, len(r2), adapter1, len(adapter1), adapter2, len(adapter2), out)
    return int(out[0]), int(out[1])
