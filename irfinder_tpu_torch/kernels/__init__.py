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

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("count.cu", "stats.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: kernel launches per wrapper since the last reset_launches()
launches: dict = {"count_blocks": 0, "intron_stats": 0}

_lib = None
_max_cap = None
#: (device, cap, n_items) -> intron_stats blocks
_grids: dict = {}


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
    count.count_blocks_launch.restype = ctypes.c_int
    count.count_blocks_launch.argtypes = [
        vp, vp, vp, vp, i64,  # blk_chrom, blk_start, blk_end, blk_strand, n
        vp, vp, vp, i64,  # uspan_key, uspan_len, uspan_off, n_uspan
        vp, i64,  # chrom_base, n_chroms
        vp, i64, i32,  # point_key, n_point, overhang
        vp, i64, i64, i64, i64,  # cnt, off_dd, w_dd, off_p, w_p
        vp,  # stream
    ]
    stats.intron_stats_launch.restype = ctypes.c_int
    stats.intron_stats_launch.argtypes = [
        vp, vp, i32,  # plane0, plane1, plane_a
        vp, i64,  # items, n_items
        vp, vp,  # runs_start, runs_len
        vp, vp, vp, vp,  # split_items, split_sums, split_hist, split_meta
        i32, i64, i32,  # cap, edge, grid
        vp, vp,  # out, stream
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


def count_blocks(dref, cnt, blk_chrom, blk_start, blk_end, blk_strand, lay, overhang: int) -> None:
    """Apply one batch's depth-diff and spans-diff updates to ``cnt`` in place
    (the fused K1+K2 kernel, csrc/count.cu).  CUDA tensors only."""
    dev = cnt.device
    if dev.type != "cuda":
        raise ValueError(f"count_blocks launches a CUDA kernel; cnt is on {dev}")
    i32, i64 = torch.int32, torch.int64
    n = blk_chrom.shape[0]
    _check(cnt, "cnt", i32, dev, lay.total)
    for nm, t in (("blk_chrom", blk_chrom), ("blk_start", blk_start),
                  ("blk_end", blk_end), ("blk_strand", blk_strand)):
        _check(t, nm, i32, dev, n)
    n_u = dref.uspan_key.shape[0]
    _check(dref.uspan_key, "uspan_key", i64, dev)
    _check(dref.uspan_len, "uspan_len", i32, dev, n_u)
    _check(dref.uspan_off, "uspan_off", i32, dev, n_u)
    _check(dref.chrom_base, "chrom_base", i32, dev)
    _check(dref.point_key, "point_key", i64, dev, lay.P + 1)
    if n == 0:
        return
    rc = load_library()["count.cu"].count_blocks_launch(
        blk_chrom.data_ptr(), blk_start.data_ptr(), blk_end.data_ptr(),
        blk_strand.data_ptr(), n,
        dref.uspan_key.data_ptr(), dref.uspan_len.data_ptr(),
        dref.uspan_off.data_ptr(), n_u,
        dref.chrom_base.data_ptr(), dref.chrom_base.shape[0],
        dref.point_key.data_ptr(), lay.P + 1, overhang,
        cnt.data_ptr(), lay.off_dd, lay.w_dd, lay.off_p, lay.w_p,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"count_blocks launch failed: cudaError {rc}")
    launches["count_blocks"] += 1


def _grid(cap: int, n_items: int) -> int:
    key = (torch.cuda.current_device(), cap, n_items)
    if key not in _grids:
        g = ctypes.c_int32(0)
        rc = load_library()["stats.cu"].intron_stats_grid(cap, n_items, ctypes.byref(g))
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


def intron_stats(depth, items, both, plane_a: int, cap: int, out) -> None:
    """Every intron subset's stats rows into ``out`` (n_rows, 7) int64, in one
    launch of the fused K3+K4 kernel (csrc/stats.cu).  ``depth`` is the
    (2, mbs) int32 depth (see check_depth), ``items`` the StatsItems and
    ``both`` the Subset "both" of ops/finalize_stats.py (its run table),
    ``plane_a`` the plane subset "A" reads.  Split introns' scratch is
    allocated zeroed here.  CUDA tensors only; no items launch nothing."""
    dev = depth.device
    if dev.type != "cuda":
        raise ValueError(f"intron_stats launches a CUDA kernel; depth is on {dev}")
    check_depth(depth)
    if plane_a not in (0, 1):
        raise ValueError(f"plane_a {plane_a}: expected 0 or 1")
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
    if out.shape != (items.n_rows, 7) or out.dtype != i64 or out.device != dev \
            or not out.is_contiguous():
        raise ValueError(f"out: expected contiguous ({items.n_rows}, 7) int64 on the depth's device")
    if cap > intron_stats_max_cap():
        raise ValueError(f"cap {cap}: the kernel takes at most {intron_stats_max_cap()} bins")
    n_items = tab.shape[0]
    if n_items == 0:
        return
    ns = items.split_items.shape[0]
    scratch = (0, 0, 0)
    if ns:
        sums = torch.zeros((ns, 8), dtype=i64, device=dev)
        hist = torch.zeros((ns, 2, cap), dtype=i32, device=dev)
        meta = torch.zeros((ns, 4), dtype=i32, device=dev)
        scratch = (sums.data_ptr(), hist.data_ptr(), meta.data_ptr())
    rc = load_library()["stats.cu"].intron_stats_launch(
        depth[0].data_ptr(), depth[1].data_ptr(), plane_a,
        tab.data_ptr(), n_items,
        both.runs_start.data_ptr(), both.runs_len.data_ptr(),
        items.split_items.data_ptr(), *scratch,
        cap, int(S.EDGE_DEPTH_WINDOW), _grid(cap, n_items),
        out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"intron_stats launch failed: cudaError {rc}")
    launches["intron_stats"] += 1
