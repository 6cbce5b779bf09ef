"""Inputs and the reference counter for checks of the port on the card.

The port carries its own copies of the host modules (see the package
docstring).  This module gathers the ones a check needs besides the engine,
so that a check imports one place:

* the synthetic inputs: ``synth_ref`` (a compiled reference map),
  ``synth_batch_arrays`` (decoded batch columns) and ``write_realistic_bam``;
* ``native_decoder``: whether the native C++ BAM decoder loads, which decides
  the decoder ``open_decoder`` takes;
* ``oracle_run`` and ``oracle_tables``: the C++ conformance counter
  (csrc/host/oracle.cpp) over the same decoded batches, and the tables
  rendered from its counters through the port's finalize and format code;
* the finalize functions the engine's finalize calls, to time that finalize
  step by step, and ``depth_stats_host``, the host path of the per-intron
  statistics (finalize._depth_stats_vectorized) that the device statistics
  must equal.
"""

from __future__ import annotations

import io
import time

from . import format as fmt
from .engine import open_decoder
from .finalize import _depth_stats_vectorized as depth_stats_host
from .finalize import detect_directionality, intron_table, junction_counters
from .io.bamgen import write_realistic_bam
from .synth import synth_batch_arrays, synth_ref

__all__ = [
    "depth_stats_host", "detect_directionality", "intron_table", "junction_counters",
    "native_decoder", "oracle_run", "oracle_tables",
    "synth_batch_arrays", "synth_ref", "write_realistic_bam",
]


def native_decoder() -> str:
    """'native', or 'python (...)' with the reason the native decoder did not
    load: open_decoder then falls back to the Python decoder."""
    from .native.bamdecode import load_library

    try:
        load_library()
    except (RuntimeError, OSError) as e:
        return f"python (native build failed: {str(e).splitlines()[0]})"
    return "native"


def oracle_run(ref, bam: str, cap_frags: int) -> tuple:
    """Decode ``bam`` once and count it with the C++ conformance counter.
    Returns (finalized counters, BAM header, decode seconds, count seconds)."""
    from .native.oracle_native import NativeOracle

    t0 = time.perf_counter()
    header, batches, _ = open_decoder(ref, bam, cap_frags)
    decoded = list(batches)
    t_dec = time.perf_counter() - t0
    orc = NativeOracle(ref, n_refids=len(header.ref_names))
    t0 = time.perf_counter()
    for b in decoded:
        orc.add_batch(b)
    out = orc.finalize()
    t_orc = time.perf_counter() - t0
    orc.close()
    return out, header, t_dec, t_orc


def oracle_tables(ref, header, fc: dict) -> dict:
    """The IR, SpansPoint, ROI and ChrCoverage tables, by file name, rendered
    from the oracle's counters ``fc``."""
    _, flip, _, _ = detect_directionality(ref, fc["exact_cnt"])
    args = (ref, fc["depth"], fc["start_cnt"], fc["end_cnt"], fc["exact_cnt"], fc["span_hits"])
    cache: dict = {}
    out = {}
    for name, fn in (
        ("IRFinder-IR-nondir.txt", lambda fh: fmt.write_ir_table(
            fh, intron_table(*args, mode="nondir", stats_cache=cache))),
        ("IRFinder-IR-dir.txt", lambda fh: fmt.write_ir_table(
            fh, intron_table(*args, mode="dir", flip_strand=flip, stats_cache=cache))),
        ("IRFinder-SpansPoint.txt", lambda fh: fmt.write_spans_point(fh, ref, fc["span_hits"])),
        ("IRFinder-ROI.txt", lambda fh: fmt.write_roi(fh, ref, fc["roi_cnt"])),
        ("IRFinder-ChrCoverage.txt", lambda fh: fmt.write_chr_coverage(
            fh, header.ref_names, fc["chr_frag"])),
    ):
        buf = io.StringIO()
        fn(buf)
        out[name] = buf.getvalue()
    return out
