"""Hand-written CUDA kernels of the port: build, binding and launch wrappers.

The sources live in ``irfinder_tpu_torch/csrc``.  Each is compiled with
``nvcc`` for ``sm_90a`` (Hopper) into its own plain-C shared library under
``irfinder_tpu_torch/_build/`` at first use, all of them at once, keyed by a
hash of the source and flags, and bound with ctypes.  Nothing here is built
or imported when the module is imported: the CPU tests import it on machines
with no ``nvcc``.

Each wrapper checks device, dtype, contiguity and shapes, raises on anything
else, launches on PyTorch's current stream and adds one to its entry in
``launches`` per launch.  There is no fallback: a wrapper that cannot build or
launch its kernel raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from .. import semantics as S
from ..ops.device_ref import FANOUT

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("count.cu", "stats.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: kernel launches per wrapper since the last reset_launches()
launches: dict = {"count_step": 0, "intron_stats": 0}
#: the batch columns count_step reads
BLOCK_COLUMNS = ("blk_chrom", "blk_start", "blk_end", "blk_strand")
FRAG_COLUMNS = ("frag_chrom", "frag_refid", "frag_start", "frag_end", "frag_strand")

_lib = None
_max_cap = None
#: (device, cap, work items) -> intron_stats blocks
_grids: dict = {}
#: (device, stream, the words) -> intron_stats' samples array on the card;
#: the words are its whole content, so a hit is always right
_samples: dict = {}
_SAMPLES_KEPT = 64


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build(verbose: bool = False) -> tuple:
    """Compile every kernel source whose library is missing, one nvcc per
    source, all started together.  Returns ({source: library path}, wall
    seconds spent compiling, compiler output)."""
    paths, jobs = {}, []
    t0 = time.perf_counter()
    for name in SOURCES:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        with open(os.path.join(SRC_DIR, name), "rb") as fh:
            h.update(fh.read())
        lib = os.path.join(BUILD_DIR, f"libirtorch_{name[:-3]}_{h.hexdigest()[:16]}.so")
        paths[name] = lib
        if os.path.exists(lib):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(SRC_DIR, name)]
        jobs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name} ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths, time.perf_counter() - t0 if jobs else 0.0, "".join(log)


def load_library() -> dict:
    """{source: ctypes library} of every kernel source, built if missing."""
    global _lib
    if _lib is not None:
        return _lib
    paths, _, _ = build()
    count, stats = ctypes.CDLL(paths["count.cu"]), ctypes.CDLL(paths["stats.cu"])
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    count.count_step_launch.restype = ctypes.c_int
    count.count_step_launch.argtypes = [
        i32,  # the trees' fan-out, which must be the kernel's
        vp, vp, vp, vp, i64,  # blk_chrom, blk_start, blk_end, blk_strand, n_blocks
        vp, vp, vp, vp, vp, i64,  # frag_chrom, _refid, _start, _end, _strand, n_frags
        vp, vp, i32,  # uspan_tree, its level sizes (host int64), levels
        vp, vp, i32,  # point_tree, its level sizes, levels
        vp, i64, vp, i64,  # uspan_rec, n_uspan, chrom_base, n_chroms
        vp, vp, vp, i32,  # roi_chrom, roi_start, roi_end, R
        i32,  # overhang
        vp, i64, i64, i64, i64, i64, i64,  # cnt, off_dd, w_dd, off_p, w_p, off_roi, off_nf
        vp, i32,  # chr, n_refids
        vp,  # stream
    ]
    stats.intron_stats_launch.restype = ctypes.c_int
    stats.intron_stats_launch.argtypes = [
        vp, i32, i64,  # samples (plane-0 addresses and plane_as), n_samples, row stride
        vp, i64,  # items, n_items
        vp, vp,  # runs_start, runs_len
        vp, i64, vp, vp, vp,  # split_items, n_split, split_sums, split_hist, split_meta
        i32, i64, i32,  # cap, edge, grid
        i64, vp, vp,  # n_rows, out, stream
    ]
    stats.intron_stats_max_cap.restype = ctypes.c_int
    stats.intron_stats_max_cap.argtypes = [ctypes.POINTER(i32)]
    stats.intron_stats_grid.restype = ctypes.c_int
    stats.intron_stats_grid.argtypes = [i32, i64, ctypes.POINTER(i32)]
    _lib = {"count.cu": count, "stats.cu": stats}
    return _lib


def intron_stats_max_cap() -> int:
    """Largest histogram (bins) intron_stats takes: what the default 48 KB of
    shared memory per block leaves for its two histograms beside the
    kernel's static arrays, as the compiled kernel reports them."""
    global _max_cap
    if _max_cap is None:
        cap = ctypes.c_int32(0)
        rc = load_library()["stats.cu"].intron_stats_max_cap(ctypes.byref(cap))
        if rc != 0:
            raise RuntimeError(f"intron_stats_max_cap failed: cudaError {rc}")
        _max_cap = cap.value
    return _max_cap


def _check(t: torch.Tensor, name: str, dtype, device, n: int | None = None) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: must be a contiguous 1-D tensor")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name}: length {t.shape[0]}, expected {n}")


def _tree(keys: torch.Tensor, sizes: tuple, n_keys: int, name: str, dev) -> tuple:
    """(keys, host int64 array of the level sizes, level count) of the search
    tree over a table of ``n_keys`` keys, checked: its level 0 is that table
    (ops/device_ref.py:search_tree), and the kernel reads its lines 16 bytes
    at a time."""
    _check(keys, name, torch.int64, dev, sum(sizes))
    if sizes[-1] != -(-(n_keys + 1) // FANOUT) * FANOUT:
        raise ValueError(f"{name}: level 0 of {sizes[-1]} keys is not a tree over {n_keys} keys")
    if keys.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")
    return keys.data_ptr(), (ctypes.c_int64 * len(sizes))(*sizes), len(sizes)


def count_step(dref, counters: dict, batch: dict, lay, overhang: int) -> None:
    """One batch's count step in one launch (csrc/count.cu): the depth-diff
    and spans-diff updates of its blocks (the fused K1+K2) and its fragment
    tallies, into ``counters["cnt"]`` and ``counters["chr"]`` in place.
    ``batch`` holds the BLOCK_COLUMNS and FRAG_COLUMNS.  CUDA tensors only."""
    cnt, chrn = counters["cnt"], counters["chr"]
    dev = cnt.device
    if dev.type != "cuda":
        raise ValueError(f"count_step launches a CUDA kernel; cnt is on {dev}")
    i32 = torch.int32
    _check(cnt, "cnt", i32, dev, lay.total)
    _check(chrn, "chr", i32, dev)
    n_b, n_f = batch["blk_chrom"].shape[0], batch["frag_chrom"].shape[0]
    for nm in BLOCK_COLUMNS:
        _check(batch[nm], nm, i32, dev, n_b)
    for nm in FRAG_COLUMNS:
        _check(batch[nm], nm, i32, dev, n_f)
    n_u = dref.uspan_key.shape[0]
    if dref.uspan_rec.shape != (n_u, 2) or dref.uspan_rec.dtype != i32 \
            or dref.uspan_rec.device != dev or not dref.uspan_rec.is_contiguous():
        raise ValueError(f"uspan_rec: expected contiguous ({n_u}, 2) int32 on {dev}")
    _check(dref.chrom_base, "chrom_base", i32, dev)
    if chrn.shape[0] < 1:
        raise ValueError("chr: needs the trash slot")
    for nm in ("roi_chrom", "roi_start", "roi_end"):
        _check(getattr(dref, nm), nm, i32, dev, lay.R + 1)
    if n_b == 0 and n_f == 0:
        return
    rc = load_library()["count.cu"].count_step_launch(
        FANOUT,
        *(batch[nm].data_ptr() for nm in BLOCK_COLUMNS), n_b,
        *(batch[nm].data_ptr() for nm in FRAG_COLUMNS), n_f,
        *_tree(dref.uspan_tree, dref.uspan_levels, n_u, "uspan_tree", dev),
        *_tree(dref.point_tree, dref.point_levels, lay.P + 1, "point_tree", dev),
        dref.uspan_rec.data_ptr(), n_u, dref.chrom_base.data_ptr(), dref.chrom_base.shape[0],
        dref.roi_chrom.data_ptr(), dref.roi_start.data_ptr(), dref.roi_end.data_ptr(), lay.R,
        overhang,
        cnt.data_ptr(), lay.off_dd, lay.w_dd, lay.off_p, lay.w_p, lay.off_roi, lay.off_nf,
        chrn.data_ptr(), chrn.shape[0] - 1,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"count_step launch failed: code {rc}")
    launches["count_step"] += 1


def _grid(cap: int, n_work: int) -> int:
    key = (torch.cuda.current_device(), cap, n_work)
    if key not in _grids:
        g = ctypes.c_int32(0)
        rc = load_library()["stats.cu"].intron_stats_grid(cap, n_work, ctypes.byref(g))
        if rc != 0:
            raise RuntimeError(f"intron_stats_grid failed: cudaError {rc}")
        _grids[key] = g.value
    return _grids[key]


#: the kernel reads each depth row in aligned groups of this many words
ROW_ALIGN = 8


def check_depth(depth) -> None:
    """The (2, mbs) int32 depth intron_stats reads: rows contiguous, each
    starting 16-byte aligned, and readable in whole ROW_ALIGN-word groups up
    to mbs rounded up (the kernel masks the words past mbs).  A row stride
    that is a multiple of ROW_ALIGN words and at least mbs rounded up, as
    ops/step.py:finalize_device makes it, meets all three."""
    if depth.dtype != torch.int32 or depth.dim() != 2 or depth.shape[0] != 2 or depth.stride(1) != 1:
        raise ValueError("depth: expected (2, mbs) int32 with contiguous rows")
    vec = -(-depth.shape[1] // ROW_ALIGN) * ROW_ALIGN
    if depth.stride(0) % ROW_ALIGN or depth.stride(0) < vec:
        raise ValueError(
            f"depth: row stride {depth.stride(0)} must be a multiple of {ROW_ALIGN} words "
            f"and at least {vec} (pad the rows, as finalize_device does)"
        )
    for k in (0, 1):
        if depth[k].data_ptr() % 16:
            raise ValueError(f"depth row {k} is not 16-byte aligned")
    if (depth.storage_offset() + depth.stride(0) + vec) * 4 > depth.untyped_storage().nbytes():
        raise ValueError("depth: the storage ends before row 1's last 4-word vector")


def _samples_array(depths: list, plane_as: list, dev) -> torch.Tensor:
    """The int64 words intron_stats reads per sample: every depth's plane-0
    address, then every plane_a; copied to the card on the current stream
    once per distinct content and stream.  The caller keeps the depths
    alive until that stream has run the launch."""
    words = tuple(d.data_ptr() for d in depths) + tuple(plane_as)
    stream = torch.cuda.current_stream(dev)
    key = (dev, stream.cuda_stream, words)
    arr = _samples.get(key)
    if arr is None:
        if len(_samples) >= _SAMPLES_KEPT:
            _samples.clear()
        host = torch.tensor(words, dtype=torch.int64).pin_memory()
        arr = _samples[key] = host.to(dev, non_blocking=True)
    return arr


def intron_stats(depths: list, items, both, plane_as: list, cap: int, out) -> None:
    """Every intron subset's stats rows of N samples into ``out`` (N, n_rows,
    7) int64, in one launch of the fused K3+K4 kernel (csrc/stats.cu).
    ``depths`` are the samples' (2, mbs) int32 depths (see check_depth), all
    on one card, with one row stride, and against one reference: ``items``
    its StatsItems and
    ``both`` its Subset "both" (the run table) of ops/finalize_stats.py;
    ``plane_as[i]`` is the plane sample i's subset "A" reads.  No depth is
    copied; split introns' scratch is allocated zeroed here, per sample.
    CUDA tensors only; no items launch nothing."""
    if not depths or len(plane_as) != len(depths):
        raise ValueError(f"{len(depths)} depths and {len(plane_as)} plane_as: expected one each, at least one")
    dev = depths[0].device
    if dev.type != "cuda":
        raise ValueError(f"intron_stats launches a CUDA kernel; depth is on {dev}")
    for d in depths:
        if d.device != dev:
            raise ValueError(f"depths on {d.device} and {dev}: expected one card")
        check_depth(d)
        if d.stride(0) != depths[0].stride(0):
            raise ValueError(f"depth row strides {d.stride(0)} and {depths[0].stride(0)}: expected one")
    if any(a not in (0, 1) for a in plane_as):
        raise ValueError(f"plane_as {list(plane_as)}: expected 0 or 1 each")
    if cap < 1:
        raise ValueError(f"cap {cap}: expected at least 1")
    i32, i64 = torch.int32, torch.int64
    tab = items.table
    if tab.dim() != 2 or tab.shape[1] != 16 or tab.dtype != i32 or tab.device != dev \
            or not tab.is_contiguous():
        raise ValueError("items: expected a contiguous (n_items, 16) int32 table on the depth's device")
    n_runs = both.runs_len.shape[0]
    _check(both.runs_start, "runs_start", i32, dev, n_runs)
    _check(both.runs_len, "runs_len", i32, dev, n_runs)
    _check(items.split_items, "split_items", i32, dev)
    n = len(depths)
    if out.shape != (n, items.n_rows, 7) or out.dtype != i64 or out.device != dev \
            or not out.is_contiguous():
        raise ValueError(f"out: expected contiguous ({n}, {items.n_rows}, 7) int64 on the depth's device")
    if cap > intron_stats_max_cap():
        raise ValueError(f"cap {cap}: the kernel takes at most {intron_stats_max_cap()} bins")
    n_items = tab.shape[0]
    if n_items == 0:
        return
    ns = items.split_items.shape[0]
    scratch = (0, 0, 0)
    if ns:
        sums = torch.zeros((n, ns, 8), dtype=i64, device=dev)
        hist = torch.zeros((n, ns, 2, cap), dtype=i32, device=dev)
        meta = torch.zeros((n, ns, 4), dtype=i32, device=dev)
        scratch = (sums.data_ptr(), hist.data_ptr(), meta.data_ptr())
    rc = load_library()["stats.cu"].intron_stats_launch(
        _samples_array(depths, plane_as, dev).data_ptr(), n, depths[0].stride(0),
        tab.data_ptr(), n_items,
        both.runs_start.data_ptr(), both.runs_len.data_ptr(),
        items.split_items.data_ptr(), ns, *scratch,
        cap, int(S.EDGE_DEPTH_WINDOW), _grid(cap, n * n_items),
        items.n_rows, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"intron_stats launch failed: cudaError {rc}")
    launches["intron_stats"] += 1
