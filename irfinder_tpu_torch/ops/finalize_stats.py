"""Per-intron depth statistics on the device: the finalize join without the
depth pull (port of irfinder_tpu/ops/finalize_stats.py).

For each intron subset ("both": every intron on the strand-summed depth; "A":
the annotation-strand-0 introns on one depth plane; "B": the strand-1
introns on the other) the statistics are, per intron, the int64 depth sum,
the nonzero-base count, the first- and last-window sums (the first and last
``min(EDGE_DEPTH_WINDOW, n)`` included bases in genomic order) and the three
nearest-rank percentile bins of a ``cap``-bin histogram of the clipped
depth, packed as ``(n_both + n_A + n_B, 7)`` int64 rows in SUBSET_ORDER.  On
a CUDA depth one launch of the hand-written kernel (kernels.intron_stats,
csrc/stats.cu) computes every row of the three subsets, walking a work-item
table built once per reference and chunk (``build_items``); on a CPU depth
the plain torch composition ``all_stats_plain`` computes them, subset by
subset (``intron_stats_plain``).  It replaces the JAX package's windowed
gather (ops/gather.py gather_window, K3) and its histogram scatter
(ops/scatter.py hist_scatter_pallas, K4).

Only the packed rows leave the card, in one pinned
D2H; the host then runs ``_host_finish``'s float64 finish op for op, so the
statistics are bit-identical to finalize._depth_stats_vectorized.  Introns
whose percentile saturates the histogram (pk >= cap-1, n > 0) take the exact
host sort over just their bases, gathered from the card.

The sums are int64 throughout.  The JAX package sums in int32 and relies on
wraparound prefix differences, which is why it splits runs at RUN_SPLIT
bases; with int64 sums no split is needed.  Its band-overflow gather
metadata, histogram tile offsets and two-level prefix tables exist only for
the TPU kernels and have no counterpart here.

``_subset_runs``, ``_ridx`` and ``_host_flat_src`` are copies of the JAX
package's numpy helpers.

The subsets "A" and "B" carry every statistic on their own introns only
(zero elsewhere); finalize.intron_table reads each variant only on its own
introns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from .. import semantics as S
from ..refio.compile import CompiledRef

#: histogram bins per intron (depths clip to [0, CAP-1]; saturated introns
#: take the exact host fallback)
CAP = 2048
#: intron-local window of the first/last-window means
EDGE = int(S.EDGE_DEPTH_WINDOW)
#: order of the subsets in the packed stats rows
SUBSET_ORDER = ("both", "A", "B")
#: most included bases of one intron a kernel work item covers: longer
#: introns split into several items (config A's longest has 7,802 bases, so
#: none splits there; a whole-genome annotation's 100 kb introns do)
CHUNK = 1 << 14
#: the int32 words of one work-item record, in the kernel's order
#: (csrc/stats.cu ItemField; two words pad the record to 64 bytes)
ITEM_FIELDS = (
    "intron", "run", "off", "loc0", "count", "split", "slot_s", "strand",
    "n", "ridx0", "ridx1", "ridx2", "seg_start", "seg_len", "pad0", "pad1",
)
_QS = (0.25, 0.50, 0.75)


@dataclasses.dataclass(frozen=True)
class Subset:
    """Run table of one intron subset, intron-major in genomic order."""

    introns: np.ndarray  # (n_sub,) int64 global intron ids
    n_bases: np.ndarray  # (n_sub,) int64 included bases per intron
    run_off: torch.Tensor  # (n_sub+1,) int64 offset of each intron's runs
    runs_start: torch.Tensor  # (R_sub,) int32 MBS start of each run
    runs_len: torch.Tensor  # (R_sub,) int32 run length in bases
    n_bases_dev: torch.Tensor  # (n_sub,) int64, n_bases on the device
    ridx: torch.Tensor  # (3, n_sub) int64 nearest-rank target indices

    @property
    def size(self) -> int:
        return int(self.introns.size)


@dataclasses.dataclass(frozen=True)
class StatsItems:
    """The kernel's work items for one chunk size, in genomic order."""

    chunk: int
    n_rows: int  # rows of the packed output the slots index
    table: torch.Tensor  # (n_items, len(ITEM_FIELDS)) int32
    split_items: torch.Tensor  # (n_split,) int32 items of each split intron

    @property
    def n_items(self) -> int:
        return int(self.table.shape[0])

    @property
    def n_split(self) -> int:
        return int(self.split_items.shape[0])


@dataclasses.dataclass(frozen=True)
class FinalizeRef:
    """Device-resident static finalize structure for one CompiledRef."""

    n_bases: np.ndarray  # (N,) int64
    subsets: dict  # "both" | "A" | "B" -> Subset
    strand: np.ndarray  # (N,) int64 intron strand (0, 1, or another code)
    #: host copies of subset "both"'s run table: (run_off, runs_start, runs_len)
    runs_host: tuple
    #: chunk -> StatsItems, built at first use
    items_cache: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def n_rows(self) -> int:
        return sum(self.subsets[k].size for k in SUBSET_ORDER)

    @property
    def device(self) -> torch.device:
        return self.subsets["both"].run_off.device

    def items(self, chunk: int = CHUNK) -> StatsItems:
        """The work items for ``chunk``, on this FinalizeRef's device."""
        if chunk not in self.items_cache:
            table, split_items = build_items(self, chunk)
            dev = self.device
            self.items_cache[chunk] = StatsItems(
                chunk=chunk,
                n_rows=self.n_rows,
                table=torch.from_numpy(table).to(dev),
                split_items=torch.from_numpy(split_items).to(dev),
            )
        return self.items_cache[chunk]


def _subset_runs(ref: CompiledRef, introns: np.ndarray):
    """Run ids of the subset's introns, intron-major order (O(#runs) host
    work).  Returns (runs, local_intron_per_run)."""
    off = ref.intron_run_off.astype(np.int64)
    counts = off[introns + 1] - off[introns]
    tot_runs = int(counts.sum())
    rep = np.repeat(np.cumsum(counts) - counts, counts)
    runs = np.repeat(off[introns], counts) + (np.arange(tot_runs, dtype=np.int64) - rep)
    local = np.repeat(np.arange(introns.size, dtype=np.int64), counts)
    return runs, local


def _ridx(n_bases: np.ndarray) -> np.ndarray:
    n = n_bases.astype(np.int64)
    out = np.zeros((3, n.size), np.int64)
    for k, q in enumerate(_QS):
        out[k] = np.minimum(np.maximum(n - 1, 0), np.maximum(0, np.ceil(q * n).astype(np.int64) - 1))
    return out


def _host_flat_src(ref: CompiledRef, global_introns: np.ndarray) -> np.ndarray:
    """Host expansion of a FEW introns' included-base MBS indices (the exact
    percentile fallback for cap-saturated introns) — same intron-major run
    order as the device pass."""
    runs, _ = _subset_runs(ref, global_introns)
    lens = ref.run_len[runs].astype(np.int64)
    starts = ref.run_mbs_start[runs].astype(np.int64)
    total = int(lens.sum())
    if not total:
        return np.zeros(0, np.int32)
    rep_off = np.repeat(np.cumsum(lens) - lens, lens)
    pos = np.arange(total, dtype=np.int64) - rep_off
    return (np.repeat(starts, lens) + pos).astype(np.int32)


def _build_subset(ref: CompiledRef, introns: np.ndarray, n_bases: np.ndarray, device) -> Subset:
    runs, _ = _subset_runs(ref, introns)
    off = ref.intron_run_off.astype(np.int64)
    counts = off[introns + 1] - off[introns]
    nb = n_bases[introns].astype(np.int64)

    def t(a, dtype):
        return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return Subset(
        introns=introns.astype(np.int64),
        n_bases=nb,
        run_off=t(np.concatenate([[0], np.cumsum(counts)]), torch.int64),
        runs_start=t(ref.run_mbs_start[runs], torch.int32),
        runs_len=t(ref.run_len[runs], torch.int32),
        n_bases_dev=t(nb, torch.int64),
        ridx=t(_ridx(nb), torch.int64),
    )


def build_finalize_ref(ref: CompiledRef, device) -> FinalizeRef:
    """The subsets' run tables on ``device``, cached on ``ref`` per device
    (they depend only on the compiled reference)."""
    device = torch.device(device)
    cache = getattr(ref, "_irtorch_finref", None)
    if cache is None:
        cache = {}
        try:
            object.__setattr__(ref, "_irtorch_finref", cache)
        except (AttributeError, TypeError):
            pass  # an object that takes no attributes: rebuild per call
    key = str(device)
    if key in cache:
        return cache[key]
    n_bases = np.zeros(ref.n_introns, np.int64)
    run_intron = np.repeat(
        np.arange(ref.n_introns), np.diff(ref.intron_run_off).astype(np.int64)
    )
    np.add.at(n_bases, run_intron, ref.run_len.astype(np.int64))
    istrand = ref.intron_strand.astype(np.int64)
    both = np.arange(ref.n_introns)
    runs, _ = _subset_runs(ref, both)
    counts = np.diff(ref.intron_run_off.astype(np.int64))
    fr = FinalizeRef(
        n_bases=n_bases,
        subsets={
            "both": _build_subset(ref, both, n_bases, device),
            "A": _build_subset(ref, np.nonzero(istrand == 0)[0], n_bases, device),
            "B": _build_subset(ref, np.nonzero(istrand == 1)[0], n_bases, device),
        },
        strand=istrand,
        runs_host=(
            np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
            ref.run_mbs_start[runs].astype(np.int64),
            ref.run_len[runs].astype(np.int64),
        ),
    )
    cache[key] = fr
    return fr


def _plane(depth: torch.Tensor, sel: int, idx=slice(None)) -> torch.Tensor:
    """The depth the subset reads (at ``idx``): plane ``sel``, or for sel 2
    the int32 (wrapping) sum of both planes, as the host path forms it."""
    return depth[0][idx] + depth[1][idx] if sel == 2 else depth[sel][idx]


def intron_stats_plain(depth: torch.Tensor, plane_sel: int, sub: Subset, cap: int) -> torch.Tensor:
    """The plain version of kernels.intron_stats: K3 (gather the depth at
    every included base) and K4 (per-intron clipped-depth histogram) composed
    as the JAX package's _hist_jit composes them, plus the per-intron sums.
    Returns (n_sub, 7) int64 rows: (sum, nnz, fw, lw, pk25, pk50, pk75)."""
    dev = depth.device
    n_sub = sub.size
    lens = sub.runs_len.to(torch.int64)
    F = int(lens.sum())
    dsum = _plane(depth, plane_sel)
    # K3: src by repeat_interleave of the run table, then one gather
    run_first = torch.cumsum(lens, 0) - lens
    src = torch.repeat_interleave(sub.runs_start.to(torch.int64) - run_first, lens, output_size=F)
    src += torch.arange(F, dtype=torch.int64, device=dev)
    vals = dsum[src]
    v64 = vals.to(torch.int64)
    nb = sub.n_bases_dev
    local = torch.repeat_interleave(torch.arange(n_sub, device=dev), nb, output_size=F)
    first = (torch.cumsum(nb, 0) - nb)[local]
    pos = torch.arange(F, dtype=torch.int64, device=dev) - first  # intron-local base
    w = torch.clamp(nb, max=EDGE)[local]
    zero = torch.zeros(n_sub, dtype=torch.int64, device=dev)
    cols = [
        zero.index_add(0, local, v64),
        zero.index_add(0, local, (vals != 0).to(torch.int64)),
        zero.index_add(0, local, torch.where(pos < w, v64, 0)),
        zero.index_add(0, local, torch.where(pos >= nb[local] - w, v64, 0)),
    ]
    # K4: hist[local*cap + clip(v)] += 1, then the percentile search
    hist = torch.zeros(n_sub * cap, dtype=torch.int32, device=dev)
    hist.index_add_(0, local * cap + vals.clamp(0, cap - 1), torch.ones_like(vals))
    hcs = torch.cumsum(hist.view(n_sub, cap), dim=1)
    cols += [(hcs < (sub.ridx[k] + 1)[:, None]).sum(dim=1) for k in range(3)]
    return torch.stack(cols, dim=1)


def build_items(finref: FinalizeRef, chunk: int) -> tuple:
    """The kernel's work-item table for ``chunk`` (host numpy).

    Each intron of subset "both" becomes ceil(n / chunk) items (one for an
    intron without bases); item k covers its intron-local bases
    [k * chunk, min(n, (k + 1) * chunk)).  A record (ITEM_FIELDS) carries the
    item's first run and its offset there, the MBS start and length of its
    first run segment, its row slots ("both": the intron id; the strand row:
    n_both + rank in "A", or n_both + n_A + rank in "B", or -1 for a strand
    other than 0 and 1), the intron's base count and nearest-rank targets,
    and a compact split id for an intron of more than one item.  Records
    are in genomic order (by intron, then by base), as the kernel wants
    them.  Returns (table (n_items, 16) int32, split_items (n_split,) int32:
    the items of each split intron)."""
    if chunk < 1:
        raise ValueError(f"chunk {chunk}: expected at least 1")
    nb = finref.n_bases.astype(np.int64)
    N = nb.size
    run_off, rs, rl = finref.runs_host
    n_it = np.maximum(1, -(-nb // chunk))
    intron = np.repeat(np.arange(N, dtype=np.int64), n_it)
    k = np.arange(intron.size, dtype=np.int64) - np.repeat(np.cumsum(n_it) - n_it, n_it)
    loc0 = k * chunk
    count = np.minimum(chunk, nb[intron] - loc0)
    # the run holding the item's first base: runs are intron-major, so the
    # item's base index in the concatenated runs locates it
    run_first = np.cumsum(rl) - rl
    gb = (np.cumsum(nb) - nb)[intron] + loc0
    if rl.size:
        run = np.clip(np.searchsorted(run_first, gb, side="right") - 1, 0, rl.size - 1)
        run = np.where(count > 0, run, np.minimum(run_off[intron], rl.size - 1))
        off = np.where(count > 0, gb - run_first[run], 0)
        seg_start = rs[run] + off
        seg_len = np.minimum(rl[run] - off, count)
    else:
        run = off = seg_start = seg_len = np.zeros(intron.size, np.int64)
    split_of = np.where(n_it > 1, np.cumsum(n_it > 1) - 1, -1)
    sizes = {k_: finref.subsets[k_].size for k_ in SUBSET_ORDER}
    st = finref.strand
    slot_s = np.full(N, -1, np.int64)
    slot_s[st == 0] = sizes["both"] + np.arange(int((st == 0).sum()))
    slot_s[st == 1] = sizes["both"] + sizes["A"] + np.arange(int((st == 1).sum()))
    ridx = _ridx(nb)
    cols = {
        "intron": intron, "run": run, "off": off, "loc0": loc0, "count": count,
        "split": split_of[intron], "slot_s": slot_s[intron],
        "strand": np.where((st == 0) | (st == 1), st, -1)[intron], "n": nb[intron],
        "ridx0": ridx[0][intron], "ridx1": ridx[1][intron], "ridx2": ridx[2][intron],
        "seg_start": seg_start, "seg_len": seg_len,
    }
    table = np.zeros((intron.size, len(ITEM_FIELDS)), np.int64)
    for j, name in enumerate(ITEM_FIELDS):
        if name in cols:
            table[:, j] = cols[name]
    if table.size and (table.max() >= 2**31 or table.min() < -1):
        raise ValueError("a work-item field does not fit int32")
    return table.astype(np.int32), n_it[n_it > 1].astype(np.int32)


def all_stats_plain(depth: torch.Tensor, finref: FinalizeRef, plane_a: int, cap: int) -> torch.Tensor:
    """The plain version of kernels.intron_stats: every subset's rows by
    intron_stats_plain, concatenated in SUBSET_ORDER ("A" reads plane
    ``plane_a``, "B" the other); an empty subset runs nothing."""
    planes = {"both": 2, "A": plane_a, "B": 1 - plane_a}
    rows = [intron_stats_plain(depth, planes[k], finref.subsets[k], cap)
            for k in SUBSET_ORDER if finref.subsets[k].size]
    if not rows:
        return torch.empty((0, 7), dtype=torch.int64, device=depth.device)
    return torch.cat(rows)


def _host_finish(n_bases, sub: Subset, rows: np.ndarray, sat_vals_fn, cap: int, info: dict | None):
    """Packed int64 rows -> the 7-tuple, with _host_finish's float64 ops in
    its order (bit-identical to finalize._depth_stats_vectorized).
    sat_vals_fn(sat) pulls the cap-saturated introns' per-base depths."""
    N = n_bases.size
    sums = np.zeros(N, np.int64)
    nzs = np.zeros(N, np.int64)
    fws = np.zeros(N, np.int64)
    lws = np.zeros(N, np.int64)
    for col, arr in enumerate((sums, nzs, fws, lws)):
        arr[sub.introns] = rows[:, col]
    nb = n_bases
    nz_mask = nb > 0
    cov = np.zeros(N)
    mean = np.zeros(N)
    firstw = np.zeros(N)
    lastw = np.zeros(N)
    cov[nz_mask] = nzs[nz_mask] / nb[nz_mask]
    mean[nz_mask] = sums[nz_mask] / nb[nz_mask]
    w = np.minimum(EDGE, nb)
    firstw[nz_mask] = fws[nz_mask] / w[nz_mask]
    lastw[nz_mask] = lws[nz_mask] / w[nz_mask]

    p = np.zeros((3, N), np.int64)
    n_sat = 0
    if sub.size:
        pk = rows[:, 4:7].T.copy()
        # saturated percentiles: exact host sort over just those bases
        sat = np.nonzero(((pk >= cap - 1).any(axis=0)) & (sub.n_bases > 0))[0]
        n_sat = int(sat.size)
        if sat.size:
            pulled = sat_vals_fn(sat)
            off = np.concatenate([[0], np.cumsum(sub.n_bases[sat])])
            for j_, i_loc in enumerate(sat):
                d = np.sort(pulled[off[j_] : off[j_ + 1]])
                for k, q in enumerate(_QS):
                    r = min(d.size - 1, max(0, int(np.ceil(q * d.size)) - 1))
                    pk[k, i_loc] = d[r]
        for k in range(3):
            p[k, sub.introns] = np.where(sub.n_bases > 0, pk[k], 0)
    if info is not None:
        info["saturated"] = info.get("saturated", 0) + n_sat
    return cov, mean, p[0], p[1], p[2], firstw, lastw


def subset_planes(flip: bool) -> dict:
    """Subset -> the depth plane it reads (2 = both planes summed): the
    library polarity ``flip`` decides which plane feeds subset A."""
    plane_a = 1 if flip else 0
    return {"both": 2, "A": plane_a, "B": 1 - plane_a}


def launch_all_stats(
    finref: FinalizeRef, depth: torch.Tensor, flip: bool, cap: int = CAP, chunk: int = CHUNK,
) -> torch.Tensor:
    """Every subset's stats rows, packed (finref.n_rows, 7) int64 on depth's
    device in SUBSET_ORDER: one kernel launch for a CUDA depth (work items of
    at most ``chunk`` bases), the plain version for a CPU one."""
    plane_a = subset_planes(flip)["A"]
    if not depth.is_cuda:
        return all_stats_plain(depth, finref, plane_a, cap)
    out = torch.empty((finref.n_rows, 7), dtype=torch.int64, device=depth.device)
    kernels.intron_stats(depth, finref.items(chunk), finref.subsets["both"], plane_a, cap, out)
    return out


def pull_async(t: torch.Tensor):
    """Start the D2H of ``t`` into pinned host memory; returns a zero-arg
    callable yielding the numpy copy once the copy is done."""
    if not t.is_cuda:
        return lambda: t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def get():
        done.synchronize()
        return host.numpy()

    return get


def finish_all_stats(
    ref: CompiledRef, finref: FinalizeRef, depth: torch.Tensor, flip: bool,
    rows: np.ndarray, cap: int = CAP, info: dict | None = None,
) -> dict:
    """Packed rows -> {2: both, plane_a: A, 1-plane_a: B}, each the 7-tuple,
    keyed as finalize.intron_table's stats_cache expects."""
    planes = subset_planes(flip)
    out = {}
    pos = 0
    for k in SUBSET_ORDER:
        sub = finref.subsets[k]
        r = rows[pos : pos + sub.size]
        pos += sub.size

        def sat_vals(sat, sub=sub, sel=planes[k]):
            idx = torch.from_numpy(_host_flat_src(ref, sub.introns[sat]).astype(np.int64))
            return _plane(depth, sel, idx.to(depth.device)).cpu().numpy()

        out[planes[k]] = _host_finish(finref.n_bases, sub, r, sat_vals, cap, info)
    return out


def device_all_stats_async(
    ref: CompiledRef, finref: FinalizeRef, depth: torch.Tensor, flip: bool,
    cap: int = CAP, info: dict | None = None,
):
    """Launch every subset's pass and the one D2H of the packed rows without
    blocking; returns a zero-arg callable that waits for the copy and runs
    the host finish."""
    get = pull_async(launch_all_stats(finref, depth, flip, cap))
    return lambda: finish_all_stats(ref, finref, depth, flip, get(), cap, info)


def device_all_stats(
    ref: CompiledRef, finref: FinalizeRef, depth: torch.Tensor, flip: bool,
    cap: int = CAP, info: dict | None = None,
) -> dict:
    """All three stats variants of the (2, mbs) int32 ``depth``: the
    strand-summed plane over every intron and each plane's annotation-strand
    subset, keyed {2, plane_a, 1-plane_a} as intron_table's stats_cache.
    ``info``, when given, receives the number of saturated introns."""
    return device_all_stats_async(ref, finref, depth, flip, cap, info)()
