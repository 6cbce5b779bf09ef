"""ctypes binding for the native BAM decoder (csrc/host/bamdecode.cpp).

Produces the identical PackedBatch stream as the pure-Python decoder
(io/bampy.py, the conformance spec), with multi-threaded BGZF inflation.
Every batch has all its columns filled.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator

import numpy as np

from ..io.bampy import BamHeader, DecodeStats
from ..io.batch import PackedBatch
from .. import semantics as S
from . import ensure_built

_I32P = ctypes.POINTER(ctypes.c_int32)


class _BdBatchView(ctypes.Structure):
    _fields_ = (
        [(n, _I32P) for n in (
            "blk_chrom", "blk_start", "blk_end", "blk_strand",
            "gap_chrom", "gap_start", "gap_end", "gap_strand",
            "frag_chrom", "frag_refid", "frag_start", "frag_end", "frag_strand",
            "frag_nblk",
        )]
        + [(n, ctypes.c_int64) for n in (
            "n_blocks", "n_gaps", "n_frags", "n_reads",
            "cap_blocks", "cap_gaps", "cap_frags",
        )]
    )


_lib = None


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built("bamdecode")
    lib = ctypes.CDLL(path)
    lib.bd_open_ex.restype = ctypes.c_void_p
    lib.bd_open_ex.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.bd_open_ex2.restype = ctypes.c_void_p
    lib.bd_open_ex2.argtypes = lib.bd_open_ex.argtypes + [
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.bd_error.restype = ctypes.c_char_p
    lib.bd_error.argtypes = [ctypes.c_void_p]
    lib.bd_n_refs.argtypes = [ctypes.c_void_p]
    lib.bd_ref_name.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.bd_ref_len.restype = ctypes.c_int64
    lib.bd_ref_len.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bd_open_fd.restype = ctypes.c_void_p
    lib.bd_open_fd.argtypes = [
        ctypes.c_int, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ]
    lib.bd_set_chrom_lut.argtypes = [ctypes.c_void_p, _I32P, ctypes.c_int64]
    lib.bd_next_batch.argtypes = [ctypes.c_void_p, ctypes.POINTER(_BdBatchView)]
    lib.bd_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.bd_semantics.argtypes = [ctypes.POINTER(ctypes.c_int32)]
    lib.bd_close.argtypes = [ctypes.c_void_p]
    # The admission constants are INJECTED per-handle via bd_open_ex (so an
    # IRTPU_SEMANTICS override never needs a rebuild); bd_semantics only
    # reports the binary's compiled-in defaults.
    _lib = lib
    return lib


def _fill_col(dst: np.ndarray, ptr, n_used: int) -> None:
    if n_used:
        dst[:n_used] = np.ctypeslib.as_array(ptr, shape=(n_used,))


def decode_bam_native(
    path: str,
    chrom_index: dict,
    cap_frags: int = 1 << 15,
    n_threads: int | None = None,
    blocks_per_frag: int = 3,
    gaps_per_frag: int = 1,
):
    """Native analog of io.bampy.decode_bam, file-path based.

    Returns (header, batch_iterator, stats); stats totals are filled as the
    iterator is consumed.

    blocks_per_frag / gaps_per_frag set the batch column geometry
    (io/batch.py BLOCKS_PER_FRAG or the LONGREAD_* values for --long-reads)."""
    lib = load_library()
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 4)
    h = lib.bd_open_ex2(
        path.encode(), cap_frags, n_threads,
        S.FLAG_DROP_MASK, S.MIN_MAPQ, S.MIN_GAP_AS_JUNCTION,
        None, 0, blocks_per_frag, gaps_per_frag,
    )
    return _wrap_handle(lib, h, chrom_index)


def decode_bam_native_fd(
    fd: int,
    chrom_index: dict,
    cap_frags: int = 1 << 15,
    n_threads: int | None = None,
    blocks_per_frag: int = 3,
    gaps_per_frag: int = 1,
    tee_fd: int = -1,
):
    """Streaming analog of decode_bam_native: count straight off a file
    descriptor carrying a BGZF BAM stream (the aligner pipe in FastQ
    --stream, SURVEY.md §3.2 — the reference counter read the aligner's
    stream directly).  Same multithreaded inflate pipeline as the file path;
    the fd is dup()ed by the native side, so the caller keeps ownership.
    tee_fd >= 0 spools the raw stream as it is read (--keep-bam)."""
    lib = load_library()
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 4)
    h = lib.bd_open_fd(
        fd, cap_frags, n_threads,
        S.FLAG_DROP_MASK, S.MIN_MAPQ, S.MIN_GAP_AS_JUNCTION,
        blocks_per_frag, gaps_per_frag, tee_fd,
    )
    return _wrap_handle(lib, h, chrom_index)


def _wrap_handle(lib, h, chrom_index: dict):
    err = lib.bd_error(h)
    if err:
        msg = err.decode()
        lib.bd_close(h)
        raise ValueError(f"bamdecode: {msg}")
    n = lib.bd_n_refs(h)
    names, lengths = [], []
    buf = ctypes.create_string_buffer(4096)
    for i in range(n):
        lib.bd_ref_name(h, i, buf, 4096)
        names.append(buf.value.decode())
        lengths.append(int(lib.bd_ref_len(h, i)))
    header = BamHeader("", names, lengths)
    lut = np.array([chrom_index.get(nm, -1) for nm in names], dtype=np.int32)
    lut = np.ascontiguousarray(lut)
    header.chrom_lut = lut
    lib.bd_set_chrom_lut(h, lut.ctypes.data_as(_I32P), len(lut))
    stats = DecodeStats()

    def gen() -> Iterator[PackedBatch]:
        view = _BdBatchView()
        try:
            while True:
                rc = lib.bd_next_batch(h, ctypes.byref(view))
                if rc < 0:
                    raise ValueError(f"bamdecode: {lib.bd_error(h).decode()}")
                if rc == 0:
                    break
                nb, ng, nf = int(view.n_blocks), int(view.n_gaps), int(view.n_frags)
                pb = PackedBatch.empty(
                    int(view.cap_blocks), int(view.cap_gaps), int(view.cap_frags)
                )
                cols = [
                    ("gap_chrom", ng), ("gap_start", ng),
                    ("gap_end", ng), ("gap_strand", ng),
                    ("blk_chrom", nb), ("blk_start", nb),
                    ("blk_end", nb), ("blk_strand", nb),
                    ("frag_chrom", nf), ("frag_refid", nf),
                    ("frag_start", nf), ("frag_end", nf),
                    ("frag_strand", nf), ("frag_nblk", nf),
                ]
                for nm, n in cols:
                    _fill_col(getattr(pb, nm), getattr(view, nm), n)
                pb.n_blocks, pb.n_gaps, pb.n_frags = nb, ng, nf
                pb.n_reads = int(view.n_reads)
                yield pb
        finally:
            st = (ctypes.c_int64 * 6)()
            lib.bd_stats(h, st)
            stats.reads_total = int(st[0])
            stats.reads_admitted = int(st[1])
            stats.fragments = int(st[2])
            stats.pairs = int(st[3])
            stats.singles = int(st[4])
            stats.blocks_inflated = int(st[5])
            lib.bd_close(h)

    return header, gen(), stats
