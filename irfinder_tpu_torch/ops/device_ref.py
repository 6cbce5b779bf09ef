"""Device-resident reference tables as PyTorch tensors.

Port of irfinder_tpu/ops/device_ref.py.  Each lookup table is one sorted int64
key column, ``chrom * 2**32 + coord``, padded with one lex-+inf sentinel row
(chrom = PAD_CHROM), so a binary search (``torch.searchsorted`` here, a plain
CUDA binary search in csrc/count.cu) never needs per-chromosome branching.
The key is built by multiplication, never by a bit-OR, so a negative coord
(``end - OH`` near 0) keeps the lexicographic order.

The JAX package's BucketTable and packed RankTables are TPU gather
workarounds and have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..refio.compile import CompiledRef

#: Sentinel chromosome id of the pad row (the JAX package's PAD_CHROM)
PAD_CHROM = 2**31 - 1

#: the JAX DeviceRef columns a port DeviceRef is built from (numpy, each
#: sentinel-padded like the JAX ones) plus the static MBS size
COLUMNS = (
    "uspan_chrom", "uspan_start", "uspan_len", "uspan_off", "chrom_base",
    "point_chrom", "point_coord", "roi_chrom", "roi_start", "roi_end",
    "mbs_size_static",
)


@dataclasses.dataclass(frozen=True)
class DeviceRef:
    """Reference tensors on one device plus static sizes."""

    # measured-base-space spans; the sentinel row has len 0 and off = mbs
    uspan_key: torch.Tensor  # int64 (U+1,)
    uspan_len: torch.Tensor  # int32 (U+1,)
    uspan_off: torch.Tensor  # int32 (U+1,) MBS offset; [-1] is the trash rank
    chrom_base: torch.Tensor  # int32 (n_chroms,) MBS offset of each chrom's first span
    point_key: torch.Tensor  # int64 (P+1,) boundary points, sentinel-padded
    roi_chrom: torch.Tensor  # int32 (R+1,) ROI intervals, sentinel-padded
    roi_start: torch.Tensor
    roi_end: torch.Tensor
    mbs_size: int
    P: int
    R: int

    @property
    def device(self) -> torch.device:
        return self.uspan_key.device


def make_key(chrom, coord):
    """(chrom, coord) -> int64 key whose order is the lexicographic order."""
    if isinstance(chrom, torch.Tensor):
        return chrom.to(torch.int64) * (1 << 32) + coord.to(torch.int64)
    return np.asarray(chrom, np.int64) * (1 << 32) + np.asarray(coord, np.int64)


def _chrom_col(seg: np.ndarray) -> np.ndarray:
    return np.repeat(
        np.arange(len(seg) - 1, dtype=np.int32), np.diff(seg).astype(np.int64)
    )


def _pad_sentinel(*cols: np.ndarray) -> list:
    """Append one sentinel row (first col = PAD_CHROM, rest = 0)."""
    out = [np.concatenate([cols[0], [PAD_CHROM]]).astype(np.int32)]
    for c in cols[1:]:
        out.append(np.concatenate([c, [0]]).astype(np.int32))
    return out


def ref_columns(ref: CompiledRef) -> dict:
    """The JAX DeviceRef's columns of ``ref``, as numpy, computed the way
    irfinder_tpu/ops/device_ref.py:build_device_ref computes them (no pads)."""
    u_chrom = _chrom_col(ref.uspan_seg)
    u_len = (ref.uspan_end - ref.uspan_start).astype(np.int32)
    u_off = ref.uspan_mbs_off[:-1].astype(np.int32) if ref.uspan_start.size else np.zeros(0, np.int32)
    mbs = int(ref.uspan_mbs_off[-1]) if ref.uspan_mbs_off.size else 0
    chrom_base = ref.uspan_mbs_off[ref.uspan_seg[:-1]].astype(np.int32)
    uc, us, ul, uo = _pad_sentinel(u_chrom, ref.uspan_start, u_len, u_off)
    uo[-1] = mbs  # sentinel offset = real MBS size (also the trash rank)
    pc, pv = _pad_sentinel(_chrom_col(ref.point_seg), ref.point_coord)
    rc, rs, re_ = _pad_sentinel(_chrom_col(ref.roi_seg), ref.roi_start, ref.roi_end)
    return {
        "uspan_chrom": uc, "uspan_start": us, "uspan_len": ul, "uspan_off": uo,
        "chrom_base": chrom_base if chrom_base.size else np.zeros(1, np.int32),
        "point_chrom": pc, "point_coord": pv,
        "roi_chrom": rc, "roi_start": rs, "roi_end": re_,
        "mbs_size_static": mbs,
    }


def from_columns(cols: dict, device) -> DeviceRef:
    """Build a DeviceRef on ``device`` from the JAX DeviceRef's columns."""
    missing = [k for k in COLUMNS if k not in cols]
    if missing:
        raise KeyError(f"missing DeviceRef columns: {missing}")

    def t32(name):
        return torch.tensor(np.asarray(cols[name], np.int32), device=device)

    def key(c, v):
        return torch.tensor(make_key(cols[c], cols[v]), device=device)

    return DeviceRef(
        uspan_key=key("uspan_chrom", "uspan_start"),
        uspan_len=t32("uspan_len"),
        uspan_off=t32("uspan_off"),
        chrom_base=t32("chrom_base"),
        point_key=key("point_chrom", "point_coord"),
        roi_chrom=t32("roi_chrom"),
        roi_start=t32("roi_start"),
        roi_end=t32("roi_end"),
        mbs_size=int(cols["mbs_size_static"]),
        P=len(cols["point_coord"]) - 1,
        R=len(cols["roi_start"]) - 1,
    )


def build_device_ref(ref: CompiledRef, device="cpu") -> DeviceRef:
    """Host CompiledRef -> reference tensors on ``device``."""
    return from_columns(ref_columns(ref), device)


def mbs_rank(dref: DeviceRef, chrom: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Measured-base-space rank: the number of included bases on ``chrom``
    strictly before ``pos`` (int32).  Pad lanes (chrom < 0) return mbs, the
    trash rank, so a padded block adds +1 and -1 at the same slot.  A chrom id
    past the table ranks at mbs, as the TPU rank kernel has it."""
    chrom64 = chrom.to(torch.int64)
    j = torch.searchsorted(dref.uspan_key, make_key(chrom, pos), right=True) - 1
    jc = j.clamp(min=0)
    kj = dref.uspan_key[jc]
    same = (j >= 0) & ((kj >> 32) == chrom64)
    within = pos.to(torch.int64) - (kj - chrom64 * (1 << 32))
    within = torch.minimum(within.clamp(min=0), dref.uspan_len[jc].to(torch.int64))
    mbs = dref.uspan_off[-1].to(torch.int64)
    n_chroms = dref.chrom_base.shape[0]
    base = torch.where(
        chrom64 < n_chroms,
        dref.chrom_base[chrom64.clamp(0, n_chroms - 1)].to(torch.int64),
        mbs,
    )
    rank = torch.where(same, dref.uspan_off[jc].to(torch.int64) + within, base)
    return torch.where(chrom64 >= 0, rank, mbs).to(torch.int32)
