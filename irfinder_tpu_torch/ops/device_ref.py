"""Device-resident reference tables as PyTorch tensors.

Port of irfinder_tpu/ops/device_ref.py.  Each lookup table is one sorted int64
key column, ``chrom * 2**32 + coord``, padded with one lex-+inf sentinel row
(chrom = PAD_CHROM), so a search never needs per-chromosome branching.  The
key is built by multiplication, never by a bit-OR, so a negative coord
(``end - OH`` near 0) keeps the lexicographic order.

The plain path searches the key columns with ``torch.searchsorted``.  The
count kernel (csrc/count.cu) searches a static B+-tree over each of them
(``search_tree``), built once per DeviceRef; ``tree_rank_plain`` is the plain
model of its descent, for the tests.

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
#: keys per search-tree node: one 128-byte line of int64 keys
FANOUT = 16
#: the search trees' padding key, above every query key
INT64_MAX = 2**63 - 1

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

    # measured-base-space spans; the sentinel row has len 0 and off = mbs.
    # Each table is stored once: a key column is the front of its search
    # tree's level 0 (search_tree: levels, root first), and a span's (len,
    # off) is one 8-byte record of uspan_rec, as the count kernel reads them
    uspan_key: torch.Tensor  # int64 (U+1,), a view of uspan_tree
    uspan_len: torch.Tensor  # int32 (U+1,), the view uspan_rec[:, 0]
    uspan_off: torch.Tensor  # int32 (U+1,), uspan_rec[:, 1]: MBS offset; [-1] is the trash rank
    chrom_base: torch.Tensor  # int32 (n_chroms,) MBS offset of each chrom's first span
    point_key: torch.Tensor  # int64 (P+1,) boundary points, sentinel-padded; a view of point_tree
    uspan_rec: torch.Tensor  # int32 (U+1, 2)
    uspan_tree: torch.Tensor  # int64, the levels of uspan_key's tree
    uspan_levels: tuple  # keys in each of those levels
    point_tree: torch.Tensor  # int64, the levels of point_key's tree
    point_levels: tuple
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


def _pad_rows(cols, target: int) -> list:
    """Pad raw table columns to ``target`` rows with sentinel rows
    (PAD_CHROM, 0, ...): they sort last and match no query."""
    extra = target - int(cols[0].shape[0])
    if extra < 0:
        raise ValueError("pad target smaller than table")
    out = [np.concatenate([cols[0], np.full(extra, PAD_CHROM, np.int32)]).astype(np.int32)]
    for c in cols[1:]:
        out.append(np.concatenate([c, np.zeros(extra, np.int32)]).astype(np.int32))
    return out


def ref_columns(ref: CompiledRef, pads: dict | None = None) -> dict:
    """The JAX DeviceRef's columns of ``ref``, as numpy, computed the way
    irfinder_tpu/ops/device_ref.py:build_device_ref computes them.

    ``pads`` ({uspan, point, roi, mbs}, parallel/genome.py ShardPlan.pads)
    gives refs of different real sizes one shape, as the genome shards of a
    mesh share one counter layout: extra rows are sentinel rows, the last
    row's ``uspan_off`` still holds the real MBS size (the trash rank), and
    ``mbs_size_static``, which sizes the counters, is the padded one."""
    u_chrom = _chrom_col(ref.uspan_seg)
    u_start = ref.uspan_start
    u_len = (ref.uspan_end - ref.uspan_start).astype(np.int32)
    u_off = ref.uspan_mbs_off[:-1].astype(np.int32) if ref.uspan_start.size else np.zeros(0, np.int32)
    mbs = int(ref.uspan_mbs_off[-1]) if ref.uspan_mbs_off.size else 0
    chrom_base = ref.uspan_mbs_off[ref.uspan_seg[:-1]].astype(np.int32)
    pt = (_chrom_col(ref.point_seg), ref.point_coord)
    ro = (_chrom_col(ref.roi_seg), ref.roi_start, ref.roi_end)
    mbs_static = mbs
    if pads:
        u_chrom, u_start, u_len, u_off = _pad_rows((u_chrom, u_start, u_len, u_off), pads["uspan"])
        pt = _pad_rows(pt, pads["point"])
        ro = _pad_rows(ro, pads["roi"])
        mbs_static = pads["mbs"]
    uc, us, ul, uo = _pad_sentinel(u_chrom, u_start, u_len, u_off)
    uo[-1] = mbs  # sentinel offset = real MBS size (also the trash rank)
    pc, pv = _pad_sentinel(*pt)
    rc, rs, re_ = _pad_sentinel(*ro)
    return {
        "uspan_chrom": uc, "uspan_start": us, "uspan_len": ul, "uspan_off": uo,
        "chrom_base": chrom_base if chrom_base.size else np.zeros(1, np.int32),
        "point_chrom": pc, "point_coord": pv,
        "roi_chrom": rc, "roi_start": rs, "roi_end": re_,
        "mbs_size_static": mbs_static,
    }


def from_columns(cols: dict, device) -> DeviceRef:
    """Build a DeviceRef on ``device`` from the JAX DeviceRef's columns."""
    missing = [k for k in COLUMNS if k not in cols]
    if missing:
        raise KeyError(f"missing DeviceRef columns: {missing}")

    def t32(name):
        return torch.tensor(np.asarray(cols[name], np.int32), device=device)

    def tree(c, v):
        """(tree, levels, the key column as a view of the tree's level 0)"""
        keys = torch.tensor(make_key(cols[c], cols[v]), device=device)
        t, levels = search_tree(keys)
        first = sum(levels[:-1])
        return t, levels, t[first : first + keys.shape[0]]

    uspan_tree, uspan_levels, uspan_key = tree("uspan_chrom", "uspan_start")
    point_tree, point_levels, point_key = tree("point_chrom", "point_coord")
    uspan_rec = torch.stack([t32("uspan_len"), t32("uspan_off")], 1)
    return DeviceRef(
        uspan_key=uspan_key,
        uspan_len=uspan_rec[:, 0],
        uspan_off=uspan_rec[:, 1],
        chrom_base=t32("chrom_base"),
        point_key=point_key,
        uspan_rec=uspan_rec,
        uspan_tree=uspan_tree,
        uspan_levels=uspan_levels,
        point_tree=point_tree,
        point_levels=point_levels,
        roi_chrom=t32("roi_chrom"),
        roi_start=t32("roi_start"),
        roi_end=t32("roi_end"),
        mbs_size=int(cols["mbs_size_static"]),
        P=len(cols["point_coord"]) - 1,
        R=len(cols["roi_start"]) - 1,
    )


def search_tree(keys: torch.Tensor) -> tuple:
    """A static B+-tree over the sorted int64 ``keys``, on their device.

    A node is FANOUT keys (one 128-byte line).  Level 0 is ``keys`` padded
    with INT64_MAX to a whole number of nodes, with at least one pad; each
    level above holds the last (largest) key of every node of the level
    below, padded the same way, up to a root of one node.  Every level
    therefore ends in INT64_MAX, which no query key reaches.  Returns (the
    levels concatenated, root first; the number of keys in each level, root
    first).  A search from the root (tree_rank_plain) returns what
    ``torch.searchsorted(keys, q)`` returns."""
    f = FANOUT

    def pad(level, n):
        return torch.cat([level, level.new_full((n - level.shape[0],), INT64_MAX)])

    level = pad(keys, -(-(keys.shape[0] + 1) // f) * f)
    levels = [level]
    while level.shape[0] > f:
        up = level[f - 1 :: f]
        level = pad(up, -(-up.shape[0] // f) * f)
        levels.append(level)
    levels.reverse()
    return torch.cat(levels), tuple(int(x.shape[0]) for x in levels)


def tree_rank_plain(tree: torch.Tensor, levels: tuple, q: torch.Tensor, right: bool, start: int = 0):
    """The plain model of the count kernel's search (csrc/count.cu
    tree_rank), for the tests: #keys < q (``right`` False) or <= q (True)
    over the tree's level 0, int64.

    The kernel stages one level (index ``start``, root first) in shared
    memory and binary-searches it with a fixed number of halvings; the rank
    there is the node to visit one level down.  In each node below it reads
    the largest key of every 4-key sector (one line from the cache), counts
    the sectors wholly below q, then counts the first three keys of the next
    sector: the node's keys below q."""
    f = FANOUT
    offs = [0]
    for n in levels:
        offs.append(offs[-1] + n)
    q = q.to(torch.int64)

    def below(idx):
        k = tree[idx]
        return ((k <= q) if right else (k < q)).to(torch.int64)

    lo = torch.zeros_like(q)
    n = levels[start]
    while n > 1:
        half = n // 2
        lo = lo + half * below(offs[start] + lo + half - 1)
        n -= half
    node = lo + below(offs[start] + lo)
    for lvl in range(start + 1, len(levels)):
        base = offs[lvl] + node * f
        sector = sum(below(base + 4 * m + 3) for m in range(f // 4))
        first = base + 4 * sector
        node = node * f + 4 * sector + sum(below(first + i) for i in range(3))
    return node


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
