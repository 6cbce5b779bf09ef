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

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("count.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

#: kernel launches per wrapper since the last reset_launches()
launches: dict = {"count_blocks": 0}

_lib = None


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
    _lib = lib
    return lib


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
