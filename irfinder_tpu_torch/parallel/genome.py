"""Genome-axis map sharding: port of irfinder_tpu/parallel/genome.py.

The reference map, not only the read stream, is split across the cells of a
mesh, so whole-genome MBS counters never have to sit in one cell.

* Shards are contiguous chromosome ranges, balanced by measured-base count
  (``plan_shards``).  Every CompiledRef table is sorted by chromosome with
  per-chromosome segment offsets, so a shard is a slice of every table
  (``slice_ref``); global chromosome ids are kept, with zero-width segments
  for the chromosomes the shard does not own.
* Every shard's tables are padded to the largest shard's sizes
  (``ShardPlan.pads``), so all shards share one counter layout; the real
  sizes stay in the plan and drive the reassembly.
* A cell counts a batch against its shard with the ordinary count step
  (ops/step.py).  Queries on chromosomes the shard does not own neutralise
  themselves: their depth and spans pairs land on one slot, +1 and -1, and
  no ROI row matches them.  Replicated batches give every shard every
  fragment, so the per-refid tally is taken from shard 0; routed batches
  (``route_flat_batch``) give each shard its own chromosomes' reads, and the
  tallies are summed over the shards.
* The merge sums each shard's counters over dp (integers: any order gives
  the same sums) and concatenates the shards in chromosome order.

The host functions (ShardPlan, plan_shards, slice_ref, _seg_slice,
_round_cap, route_flat_batch, reassemble_counters) are copies of the JAX
package's, with one repair in route_flat_batch (see its docstring).  Where
the JAX package stacks the shards' DeviceRefs and counters into one pytree
under shard_map, the port keeps a list, one entry per shard or cell, each on
its own torch device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from ..ops.device_ref import ref_columns
from ..ops.step import CounterLayout
from ..refio.compile import CompiledRef
from .shard import merge_stacked


@dataclasses.dataclass
class ShardPlan:
    """Contiguous chrom ranges + per-shard real sizes + uniform pad sizes."""

    bounds: list  # (G+1,) chrom-range boundaries; shard i owns [b[i], b[i+1])
    pads: dict  # uniform table sizes {uspan,bstart,bend,pair,point,roi,mbs}
    real: list  # per-shard dict of real sizes incl. real mbs

    @property
    def layout(self) -> CounterLayout:
        """The counter layout every shard's counters share (padded sizes)."""
        return CounterLayout(mbs=self.pads["mbs"], P=self.pads["point"], R=self.pads["roi"])


def _seg_slice(seg: np.ndarray, lo_row: int, hi_row: int) -> np.ndarray:
    """Rebase a per-chrom segment-offset array onto a row slice [lo, hi)."""
    return (np.clip(seg.astype(np.int64), lo_row, hi_row) - lo_row).astype(np.int32)


def plan_shards(ref: CompiledRef, n_shards: int) -> ShardPlan:
    """Contiguous chrom partition balanced by measured-base count."""
    n_chroms = ref.n_chroms
    # per-chrom MBS sizes
    off = ref.uspan_mbs_off
    seg = ref.uspan_seg
    sizes = np.array(
        [int(off[seg[c + 1]] - off[seg[c]]) if seg[c + 1] > seg[c] else 0 for c in range(n_chroms)],
        dtype=np.int64,
    )
    total = max(1, int(sizes.sum()))
    bounds = [0]
    acc = 0
    for c in range(n_chroms):
        acc += int(sizes[c])
        b = len(bounds)  # bins closed so far
        # close bin b once it holds its fair share of measured bases
        if b < n_shards and acc * n_shards >= total * b:
            bounds.append(c + 1)
    while len(bounds) < n_shards + 1:
        bounds.append(n_chroms)
    bounds[-1] = n_chroms

    shards = [slice_ref(ref, bounds[i], bounds[i + 1]) for i in range(n_shards)]
    real = []
    for s in shards:
        real.append(
            {
                "uspan": int(s.uspan_start.size),
                "bstart": int(s.bstart_coord.size),
                "bend": int(s.bend_coord.size),
                "pair": int(s.upair_start.size),
                "point": int(s.point_coord.size),
                "roi": int(s.roi_start.size),
                "mbs": s.mbs_size,
            }
        )
    pads = {k: max(r[k] for r in real) for k in real[0]}
    return ShardPlan(bounds=bounds, pads=pads, real=real)


def slice_ref(ref: CompiledRef, c0: int, c1: int) -> CompiledRef:
    """The CompiledRef restricted to chromosomes [c0, c1), keeping GLOBAL
    chrom ids and full-length segment arrays (zero-width outside the range).
    Pure slicing: every table is sorted by chrom."""
    u0, u1 = int(ref.uspan_seg[c0]), int(ref.uspan_seg[c1])
    mbs0 = int(ref.uspan_mbs_off[u0])
    i_sel = (ref.intron_chrom >= c0) & (ref.intron_chrom < c1)
    i0 = int(np.argmax(i_sel)) if i_sel.any() else 0
    i1 = i0 + int(i_sel.sum())
    s0, s1 = int(ref.bstart_seg[c0]), int(ref.bstart_seg[c1])
    e0, e1 = int(ref.bend_seg[c0]), int(ref.bend_seg[c1])
    x0, x1 = int(ref.upair_seg[c0]), int(ref.upair_seg[c1])
    p0, p1 = int(ref.point_seg[c0]), int(ref.point_seg[c1])
    r0, r1 = int(ref.roi_seg[c0]), int(ref.roi_seg[c1])
    ro0 = int(ref.intron_run_off[i0])
    ro1 = int(ref.intron_run_off[i1])
    return CompiledRef(
        chroms=list(ref.chroms),
        intron_chrom=ref.intron_chrom[i0:i1],
        intron_start=ref.intron_start[i0:i1],
        intron_end=ref.intron_end[i0:i1],
        intron_strand=ref.intron_strand[i0:i1],
        intron_class=ref.intron_class[i0:i1],
        intron_names=list(ref.intron_names[i0:i1]),
        uspan_start=ref.uspan_start[u0:u1],
        uspan_end=ref.uspan_end[u0:u1],
        uspan_mbs_off=(ref.uspan_mbs_off[u0 : u1 + 1] - mbs0),
        uspan_seg=_seg_slice(ref.uspan_seg, u0, u1),
        intron_run_off=(ref.intron_run_off[i0 : i1 + 1] - ro0).astype(np.int32),
        run_mbs_start=(ref.run_mbs_start[ro0:ro1] - mbs0),
        run_len=ref.run_len[ro0:ro1],
        bstart_coord=ref.bstart_coord[s0:s1],
        bstart_seg=_seg_slice(ref.bstart_seg, s0, s1),
        bend_coord=ref.bend_coord[e0:e1],
        bend_seg=_seg_slice(ref.bend_seg, e0, e1),
        upair_start=ref.upair_start[x0:x1],
        upair_end=ref.upair_end[x0:x1],
        upair_seg=_seg_slice(ref.upair_seg, x0, x1),
        point_coord=ref.point_coord[p0:p1],
        point_seg=_seg_slice(ref.point_seg, p0, p1),
        intron_bstart_idx=(ref.intron_bstart_idx[i0:i1] - s0),
        intron_bend_idx=(ref.intron_bend_idx[i0:i1] - e0),
        intron_pair_idx=(ref.intron_pair_idx[i0:i1] - x0),
        intron_pstart_idx=(ref.intron_pstart_idx[i0:i1] - p0),
        intron_pend_idx=(ref.intron_pend_idx[i0:i1] - p0),
        roi_start=ref.roi_start[r0:r1],
        roi_end=ref.roi_end[r0:r1],
        roi_seg=_seg_slice(ref.roi_seg, r0, r1),
        roi_strand=ref.roi_strand[r0:r1],
        roi_names=list(ref.roi_names[r0:r1]),
    )


def shard_columns(ref: CompiledRef, plan: ShardPlan) -> list:
    """Each genome shard's DeviceRef columns (ops/device_ref.py ref_columns),
    padded to the plan's uniform sizes: the JAX package's stacked DeviceRef,
    one shard per entry.  ops/device_ref.py from_columns builds a shard's
    DeviceRef on a cell's device from them."""
    return [
        ref_columns(slice_ref(ref, plan.bounds[i], plan.bounds[i + 1]), pads=plan.pads)
        for i in range(len(plan.bounds) - 1)
    ]


def _round_cap(x: int) -> int:
    """Next quarter-power-of-two >= x (power of two with 2 mantissa bits):
    shape-rounding padding stays <= 25% (plain pow2 rounding wasted up to
    ~100% on skewed cells) while caps still take O(log) distinct values, so
    with the monotonic min_caps floor a stream's cell buffers take few
    distinct sizes (the caching allocators reuse them)."""
    if x <= 1:
        return 1
    base = 1 << (int(x).bit_length() - 1)  # largest pow2 <= x
    if base == x:
        return x
    step = max(1, base // 4)
    return base + -(-(x - base) // step) * step


def route_flat_batch(
    plan: ShardPlan,
    batch: dict,
    n_dp: int,
    n_g: int,
    lane: int = 128,
    min_caps: tuple = (0, 0),
) -> tuple[dict, np.ndarray]:
    """Partition a device-batch column dict by (dp chunk, owning genome
    shard) into flat columns, cell after cell: cell k = dp * n_g + g holds
    rows [k * cap, (k + 1) * cap) of every column of its kind.

    Rows are assigned to dp chunks contiguously and to genome shards by
    chromosome ownership (plan.bounds).  Every (dp, g) cell is padded to the
    max cell population rounded up to a quarter power of two (_round_cap),
    floored by ``lane`` and ``min_caps`` ((block_cap, frag_cap) floors a
    caller carries between batches to pin the shapes monotonically).
    Returns (batch dict, (n_dp, n_g) fragment rows per cell).

    Where this differs from the JAX package: a fragment row on a BAM
    reference absent from the compiled map (frag_chrom < 0, frag_refid >= 0)
    is kept and routed to genome shard 0 of its dp chunk, so that it still
    counts in FragmentsInChr and the fragment total, as it does unsharded;
    it matches no ROI and its blocks (chrom -1) count nothing anywhere.  The
    JAX package drops such rows (it keeps chrom >= 0 only), so its routed
    ChrCoverage table reads 0 for such a reference where the unsharded run
    counts its fragments.  Block rows with chrom < 0 and fragment pad rows
    (refid < 0) are dropped, as there."""
    bounds = np.asarray(plan.bounds)
    blk_cols = ("blk_chrom", "blk_start", "blk_end", "blk_strand")
    frag_cols = (
        "frag_chrom", "frag_refid", "frag_start", "frag_end", "frag_strand",
        "frag_nblk",
    )
    out: dict = {}
    counts = None
    for (cols, chrom_col), min_cap in zip(
        ((blk_cols, "blk_chrom"), (frag_cols, "frag_chrom")), min_caps
    ):
        chrom = np.asarray(batch[chrom_col])
        B = chrom.shape[0]
        if B % n_dp:
            raise ValueError(f"column length {B} not divisible by n_dp={n_dp}")
        sub = B // n_dp
        dp_of = np.arange(B) // sub
        valid = chrom >= 0
        if chrom_col == "frag_chrom":
            valid |= np.asarray(batch["frag_refid"]) >= 0
        # chrom < 0 lands on shard 0
        g_of = np.searchsorted(bounds, chrom, side="right") - 1
        g_of = np.clip(g_of, 0, n_g - 1)
        cell = dp_of * n_g + g_of
        n_cells = n_dp * n_g
        if n_dp == 1 and n_g <= 16:
            # G flatnonzero passes replace the stable sort, preserving
            # in-cell order by construction
            parts = [np.flatnonzero(valid & (g_of == g)) for g in range(n_g)]
            cellcnt = np.array([p.size for p in parts], dtype=np.int64)
            src = (
                np.concatenate(parts)
                if parts
                else np.zeros(0, np.int64)
            )
            cell_sorted = np.repeat(np.arange(n_cells), cellcnt)
        else:
            # stable order within each cell preserves read order per shard
            order = np.argsort(np.where(valid, cell, n_cells), kind="stable")
            cellcnt = np.bincount(cell[valid], minlength=n_cells)
            n_valid = int(valid.sum())
            src = order[:n_valid]  # valid rows, grouped by cell
            cell_sorted = cell[src]
        cap = max(lane, int(min_cap), _round_cap(int(cellcnt.max())))
        cap = int(-(-cap // lane) * lane)
        within = np.arange(len(src)) - np.repeat(
            np.concatenate([[0], np.cumsum(cellcnt)[:-1]]), cellcnt
        )
        dst = cell_sorted * cap + within
        for nm in cols:
            col = np.asarray(batch[nm])
            fill = -1 if nm in ("blk_chrom", "frag_chrom", "frag_refid") else 0
            o = np.full(n_dp * n_g * cap, fill, dtype=col.dtype)
            o[dst] = col[src]
            out[nm] = o
        if chrom_col == "frag_chrom":
            counts = cellcnt.reshape(n_dp, n_g)
    return out, counts


def merge_dp(cells: list) -> list:
    """Each genome shard's counters summed over dp: ``cells[i][g]`` is cell
    (i, g)'s {"cnt", "chr"}; returns one {"cnt", "chr"} per shard, on the
    device of its dp-0 cell.  Integer sums, so the order does not matter.
    With one dp row the cells' own tensors are returned, uncopied."""
    return [merge_stacked([row[g] for row in cells]) for g in range(len(cells[0]))]


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def reassemble_counters(
    ref: CompiledRef, plan: ShardPlan, per_shard, n_refids: int,
    routed: bool = False, with_depth: bool = True,
) -> dict:
    """Host-side merge: slice each shard's flat cnt with the (uniform padded)
    layout, drop per-shard padding using the plan's real sizes, concatenate in
    chromosome order.  Produces exactly the counters an unsharded finalize
    yields.

    per_shard: {"cnt": shards, "chr": shards}, each indexable by shard
    (a (G, L) array, or a list of tensors, one per shard, as merge_dp
    gives).  Every section is sliced before it is pulled, so only the needed
    words cross to the host.  with_depth=False skips the depth section
    (out["depth"] = None): the device finalize reassembles it on the device
    (make_depth_reassemble)."""
    if not isinstance(per_shard, dict):
        raise TypeError("reassemble_counters takes the counters dict {'cnt', 'chr'}")
    stacked_cnt = per_shard["cnt"]
    stacked_chr = np.stack([_host(c) for c in per_shard["chr"]])
    lay = plan.layout

    def sect2(i, off, w, keep):
        return _host(stacked_cnt[i][off : off + 2 * w]).reshape(2, w)[:, :keep]

    parts = {k: [] for k in ("depth", "span_hits", "roi_cnt")}
    for i in range(len(plan.real)):
        r = plan.real[i]
        if with_depth:
            dd = sect2(i, lay.off_dd, lay.mbs + 1, r["mbs"] + 1)
            parts["depth"].append(np.cumsum(dd, axis=1)[:, :-1])
        sp = sect2(i, lay.off_p, lay.P + 1, r["point"] + 1)
        parts["span_hits"].append(np.cumsum(sp, axis=1)[:, :-1])
        parts["roi_cnt"].append(sect2(i, lay.off_roi, lay.R + 1, r["roi"]))
    if not with_depth:
        parts.pop("depth")
    out = {k: np.concatenate(v, axis=1).astype(np.int32) for k, v in parts.items()}
    if not with_depth:
        out["depth"] = None
    nf = np.array([_host(stacked_cnt[i][lay.off_nf]) for i in range(len(plan.real))], np.int32)
    if routed:
        # routed batches: each genome shard counted only its own chroms'
        # fragments — the global tallies are the per-shard sums
        out["chr_frag"] = stacked_chr.sum(axis=0)[:n_refids].astype(np.int32)
        out["n_frags"] = nf.sum().astype(np.int32)
    else:
        # replicated batches: every genome shard sees the full fragment
        # stream, so shard 0's dense per-refid tally is already global
        out["chr_frag"] = stacked_chr[0][:n_refids]
        out["n_frags"] = nf[0]
    return out


def make_depth_reassemble(plan: ShardPlan):
    """The global (2, mbs) depth from the shards' merged counters, on one
    device: each shard's real depth-diff rows are cumsummed into its slice
    of one row buffer, laid out as ops/step.py depth_rows lays out the
    unsharded depth (row stride a multiple of kernels.ROW_ALIGN words), so
    kernels.intron_stats reads it directly.  Equal to the depth section of
    reassemble_counters.  Returns fn(shard cnt tensors, device) -> the
    (2, mbs) view."""
    lay = plan.layout
    reals = [r["mbs"] for r in plan.real]
    total = sum(reals)

    def go(cnts: list, device) -> torch.Tensor:
        a = kernels.ROW_ALIGN
        buf = torch.empty((2, -(-(total + 1) // a) * a), dtype=torch.int32, device=device)
        o = 0
        for c, rm in zip(cnts, reals):
            if rm:
                dd = c[lay.off_dd : lay.off_dd + 2 * (lay.mbs + 1)].view(2, lay.mbs + 1)[:, :rm]
                dd = dd.to(device)
                for k in (0, 1):
                    torch.cumsum(dd[k], 0, dtype=torch.int32, out=buf[k, o : o + rm])
            o += rm
        return buf[:, :total]

    return go
