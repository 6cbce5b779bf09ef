"""ctypes binding for the scalar C++ conformance counter (csrc/host/oracle.cpp).

A second, independent implementation of the counting semantics: the card
checks hold the port's counters and tables against it."""

from __future__ import annotations

import ctypes

import numpy as np

from .. import semantics as S
from ..refio.compile import CompiledRef
from . import ensure_built

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)

_lib = None


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    path = ensure_built("oracle")
    lib = ctypes.CDLL(path)
    lib.orc_create.restype = ctypes.c_void_p
    lib.orc_create.argtypes = [
        _I32P, _I32P, _I32P, _I64P, _I64P,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        _I32P, _I32P, ctypes.c_int64,
        _I32P, _I32P, ctypes.c_int64,
        _I32P, _I32P, _I32P, ctypes.c_int64,
        _I32P, _I32P, ctypes.c_int64,
        _I32P, _I32P, _I32P, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int64,
    ]
    lib.orc_count_batch.argtypes = [ctypes.c_void_p] + [_I32P] * 4 + [ctypes.c_int64] + [_I32P] * 4 + [ctypes.c_int64] + [_I32P] * 5 + [ctypes.c_int64]
    lib.orc_finalize.argtypes = [ctypes.c_void_p] + [_I32P] * 7 + [_I64P]
    lib.orc_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _chrom_col(seg: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(len(seg) - 1, dtype=np.int32), np.diff(seg))


class NativeOracle:
    """One counter instance over a CompiledRef.  add_batch() accepts either a
    PackedBatch or a dict of column arrays."""

    def __init__(self, ref: CompiledRef, n_refids: int | None = None):
        self.ref = ref
        self.lib = load_library()
        self.n_refids = n_refids if n_refids is not None else ref.n_chroms
        # keep every array alive for the lifetime of the handle
        self._keep = k = {}
        k["uc"] = np.ascontiguousarray(_chrom_col(ref.uspan_seg))
        k["us"] = np.ascontiguousarray(ref.uspan_start, dtype=np.int32)
        k["ul"] = np.ascontiguousarray(ref.uspan_end - ref.uspan_start, dtype=np.int32)
        k["uo"] = np.ascontiguousarray(ref.uspan_mbs_off[:-1], dtype=np.int64)
        k["cb"] = np.ascontiguousarray(
            ref.uspan_mbs_off[ref.uspan_seg[:-1]], dtype=np.int64
        )
        k["bsc"] = np.ascontiguousarray(_chrom_col(ref.bstart_seg))
        k["bs"] = np.ascontiguousarray(ref.bstart_coord, dtype=np.int32)
        k["bec"] = np.ascontiguousarray(_chrom_col(ref.bend_seg))
        k["be"] = np.ascontiguousarray(ref.bend_coord, dtype=np.int32)
        k["pc"] = np.ascontiguousarray(_chrom_col(ref.upair_seg))
        k["ps"] = np.ascontiguousarray(ref.upair_start, dtype=np.int32)
        k["pe"] = np.ascontiguousarray(ref.upair_end, dtype=np.int32)
        k["ptc"] = np.ascontiguousarray(_chrom_col(ref.point_seg))
        k["pt"] = np.ascontiguousarray(ref.point_coord, dtype=np.int32)
        k["rc"] = np.ascontiguousarray(_chrom_col(ref.roi_seg))
        k["rs"] = np.ascontiguousarray(ref.roi_start, dtype=np.int32)
        k["re"] = np.ascontiguousarray(ref.roi_end, dtype=np.int32)
        self.h = self.lib.orc_create(
            k["uc"].ctypes.data_as(_I32P), k["us"].ctypes.data_as(_I32P),
            k["ul"].ctypes.data_as(_I32P), k["uo"].ctypes.data_as(_I64P),
            k["cb"].ctypes.data_as(_I64P),
            len(k["us"]), ref.n_chroms, ref.mbs_size,
            k["bsc"].ctypes.data_as(_I32P), k["bs"].ctypes.data_as(_I32P), len(k["bs"]),
            k["bec"].ctypes.data_as(_I32P), k["be"].ctypes.data_as(_I32P), len(k["be"]),
            k["pc"].ctypes.data_as(_I32P), k["ps"].ctypes.data_as(_I32P),
            k["pe"].ctypes.data_as(_I32P), len(k["ps"]),
            k["ptc"].ctypes.data_as(_I32P), k["pt"].ctypes.data_as(_I32P), len(k["pt"]),
            k["rc"].ctypes.data_as(_I32P), k["rs"].ctypes.data_as(_I32P),
            k["re"].ctypes.data_as(_I32P), len(k["rs"]),
            S.SPANS_OVERHANG, self.n_refids,
        )

    def add_batch(self, batch) -> None:
        from ..io.batch import all_arrays_of

        b = batch if isinstance(batch, dict) else all_arrays_of(batch)
        cols = {kk: np.ascontiguousarray(v, dtype=np.int32) for kk, v in b.items()}
        self._last = cols  # keep alive during the call
        self.lib.orc_count_batch(
            self.h,
            cols["blk_chrom"].ctypes.data_as(_I32P),
            cols["blk_start"].ctypes.data_as(_I32P),
            cols["blk_end"].ctypes.data_as(_I32P),
            cols["blk_strand"].ctypes.data_as(_I32P),
            len(cols["blk_chrom"]),
            cols["gap_chrom"].ctypes.data_as(_I32P),
            cols["gap_start"].ctypes.data_as(_I32P),
            cols["gap_end"].ctypes.data_as(_I32P),
            cols["gap_strand"].ctypes.data_as(_I32P),
            len(cols["gap_chrom"]),
            cols["frag_chrom"].ctypes.data_as(_I32P),
            cols["frag_refid"].ctypes.data_as(_I32P),
            cols["frag_start"].ctypes.data_as(_I32P),
            cols["frag_end"].ctypes.data_as(_I32P),
            cols["frag_strand"].ctypes.data_as(_I32P),
            len(cols["frag_chrom"]),
        )

    def finalize(self) -> dict:
        ref = self.ref
        R = max(len(ref.roi_names), 1)
        out = {
            "depth": np.zeros((2, ref.mbs_size), np.int32),
            "start_cnt": np.zeros((2, ref.bstart_coord.size), np.int32),
            "end_cnt": np.zeros((2, ref.bend_coord.size), np.int32),
            "exact_cnt": np.zeros((2, ref.upair_start.size), np.int32),
            "span_hits": np.zeros((2, ref.point_coord.size), np.int32),
            "roi_cnt": np.zeros((2, R), np.int32),
            "chr_frag": np.zeros(self.n_refids, np.int32),
        }
        nf = ctypes.c_int64()
        self.lib.orc_finalize(
            self.h,
            *[out[kk].ctypes.data_as(_I32P) for kk in (
                "depth", "start_cnt", "end_cnt", "exact_cnt", "span_hits",
                "roi_cnt", "chr_frag",
            )],
            ctypes.byref(nf),
        )
        out["roi_cnt"] = out["roi_cnt"][:, : len(ref.roi_names)]
        out["n_frags"] = np.int32(nf.value)
        return out

    def close(self):
        if self.h:
            self.lib.orc_close(self.h)
            self.h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

