"""Hand-written CUDA kernels of the port: build, binding and launch wrappers.

The sources live in ``irfinder_tpu_torch/csrc``.  They are compiled with
``nvcc`` for ``sm_90a`` (Hopper) into a plain-C shared library under
``irfinder_tpu_torch/_build/`` at first use, keyed by a hash of the sources
and flags, and bound with ctypes.  Nothing here is built or imported when the
module is imported: the CPU tests import it on machines with no ``nvcc``.

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

from irfinder_tpu import semantics as S

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
    """Compile the kernels if the library for the current sources is missing.
    Returns (library path, seconds spent compiling, compiler output)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(SRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    lib = os.path.join(BUILD_DIR, f"libirtorch_{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, *(os.path.join(SRC_DIR, s) for s in SOURCES)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib, dt, r.stdout + r.stderr


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.count_blocks_launch.restype = ctypes.c_int
    lib.count_blocks_launch.argtypes = [
        vp, vp, vp, vp, i64,  # blk_chrom, blk_start, blk_end, blk_strand, n
        vp, vp, vp, i64,  # uspan_key, uspan_len, uspan_off, n_uspan
        vp, i64,  # chrom_base, n_chroms
        vp, i64, i32,  # point_key, n_point, overhang
        vp, i64, i64, i64, i64,  # cnt, off_dd, w_dd, off_p, w_p
        vp,  # stream
    ]
    lib.intron_stats_launch.restype = ctypes.c_int
    lib.intron_stats_launch.argtypes = [
        vp, vp, i32,  # plane0, plane1, sel
        vp, vp, vp, vp, vp,  # run_off, runs_start, runs_len, n_bases, ridx
        i64, i32, i64,  # n_sub, cap, edge
        vp, vp,  # out, stream
    ]
    lib.intron_stats_max_cap.restype = ctypes.c_int
    lib.intron_stats_max_cap.argtypes = [ctypes.POINTER(i32)]
    _lib = lib
    return lib


def intron_stats_max_cap() -> int:
    """Largest histogram (bins) intron_stats takes: what the default 48 KB of
    shared memory per block leaves beside the kernel's static arrays, as the
    compiled kernel reports them."""
    global _max_cap
    if _max_cap is None:
        cap = ctypes.c_int32(0)
        rc = load_library().intron_stats_max_cap(ctypes.byref(cap))
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
    lib = load_library()
    rc = lib.count_blocks_launch(
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


def intron_stats(depth, plane_sel: int, sub, cap: int, out) -> None:
    """Per-intron stats rows of one subset into ``out`` (n_sub, 7) int64: the
    fused K3+K4 kernel (csrc/stats.cu).  ``depth`` is the (2, mbs) int32
    depth, each row contiguous; ``plane_sel`` 0 or 1 reads that plane, 2
    their sum.  CUDA tensors only; an empty subset launches nothing."""
    dev = depth.device
    if dev.type != "cuda":
        raise ValueError(f"intron_stats launches a CUDA kernel; depth is on {dev}")
    if depth.dtype != torch.int32 or depth.dim() != 2 or depth.shape[0] != 2 or depth.stride(1) != 1:
        raise ValueError("depth: expected (2, mbs) int32 with contiguous rows")
    if plane_sel not in (0, 1, 2):
        raise ValueError(f"plane_sel {plane_sel}: expected 0, 1 or 2")
    if cap < 1:
        raise ValueError(f"cap {cap}: expected at least 1")
    i32, i64 = torch.int32, torch.int64
    n_sub = sub.n_bases_dev.shape[0]
    _check(sub.run_off, "run_off", i64, dev, n_sub + 1)
    n_runs = sub.runs_len.shape[0]
    _check(sub.runs_start, "runs_start", i32, dev, n_runs)
    _check(sub.runs_len, "runs_len", i32, dev, n_runs)
    _check(sub.n_bases_dev, "n_bases", i64, dev, n_sub)
    if sub.ridx.shape != (3, n_sub) or sub.ridx.dtype != i64 or sub.ridx.device != dev \
            or not sub.ridx.is_contiguous():
        raise ValueError("ridx: expected contiguous (3, n_sub) int64 on the depth's device")
    if out.shape != (n_sub, 7) or out.dtype != i64 or out.device != dev or not out.is_contiguous():
        raise ValueError("out: expected contiguous (n_sub, 7) int64 on the depth's device")
    if cap > intron_stats_max_cap():
        raise ValueError(f"cap {cap}: the kernel takes at most {intron_stats_max_cap()} bins")
    if n_sub == 0:
        return
    lib = load_library()
    rc = lib.intron_stats_launch(
        depth[0].data_ptr(), depth[1].data_ptr(), plane_sel,
        sub.run_off.data_ptr(), sub.runs_start.data_ptr(), sub.runs_len.data_ptr(),
        sub.n_bases_dev.data_ptr(), sub.ridx.data_ptr(),
        n_sub, cap, int(S.EDGE_DEPTH_WINDOW), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"intron_stats launch failed: cudaError {rc}")
    launches["intron_stats"] += 1
