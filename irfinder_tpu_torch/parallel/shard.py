"""Data-parallel sharding of the counting step: port of
irfinder_tpu/parallel/shard.py.

Axis dp splits the read stream: every batch column is cut into dp
contiguous row ranges, and cell i counts range i into its own counters.
Every counter update is per-lane independent (blocks, gaps and fragments
never couple inside a step), so any split counts the same; the merge is one
integer sum over the cells, exactly associative, so the result is the same
at any dp.

Where the JAX package runs the dp cells as one shard_map program over a
Mesh, the port keeps one counter dict per cell on the cell's own torch
device: the dp step is engine_mesh.MeshEngine at genome = 1, which ships
each cell its fused row range (``fused_cells``) and launches the count step
there.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..kernels import BLOCK_COLUMNS, FRAG_COLUMNS


def on_device(device: torch.device):
    """The context that makes ``device`` current for a cell's work on a CUDA
    card (launches, streams, the kernels' per-device caches), or a no-op."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def pad_batch_to_multiple(batch_arrays: dict, n: int) -> dict:
    """Pad each column array so its length divides n (pad lanes carry the
    same all-zero/-1 convention as PackedBatch.empty and provably count 0)."""
    out = {}
    for k, v in batch_arrays.items():
        rem = (-len(v)) % n
        if rem:
            fill = -1 if k.endswith("chrom") or k.endswith("refid") else 0
            v = np.concatenate([v, np.full(rem, fill, dtype=v.dtype)])
        out[k] = v
    return out


def fused_cells(arrays: dict, n: int) -> tuple:
    """Cut every column the count step reads into ``n`` contiguous row
    ranges of equal length (block and fragment columns each a multiple of n
    long) and lay each range out as PackedBatch.fused_h2d does: row r of the
    returned (n, 4 * cap_blocks + 5 * cap_frags) int32 array is range r's
    buffer for io/batch.py unpack_fused.  Returns (rows, cap_blocks,
    cap_frags)."""
    blk = np.stack([np.asarray(arrays[k], np.int32) for k in BLOCK_COLUMNS])
    frag = np.stack([np.asarray(arrays[k], np.int32) for k in FRAG_COLUMNS])
    if blk.shape[1] % n or frag.shape[1] % n:
        raise ValueError(f"columns of {blk.shape[1]} / {frag.shape[1]} rows do not split {n} ways")
    cb, cf = blk.shape[1] // n, frag.shape[1] // n
    rows = np.concatenate([
        blk.reshape(len(BLOCK_COLUMNS), n, cb).transpose(1, 0, 2).reshape(n, -1),
        frag.reshape(len(FRAG_COLUMNS), n, cf).transpose(1, 0, 2).reshape(n, -1),
    ], axis=1)
    return rows, cb, cf


def merge_stacked(cells: list) -> dict:
    """Deterministic integer merge over the cells: {"cnt", "chr"} summed on
    the first cell's device.  One cell is returned as it is, uncopied."""
    if len(cells) == 1:
        return cells[0]
    acc = {k: v.clone() for k, v in cells[0].items()}
    for c in cells[1:]:
        for k in acc:
            acc[k] += c[k].to(acc[k].device)
    return acc
