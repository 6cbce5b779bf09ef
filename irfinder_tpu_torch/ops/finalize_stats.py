"""Per-intron depth statistics on the device: the finalize join without the
depth pull (port of irfinder_tpu/ops/finalize_stats.py).

For each intron subset ("both": every intron on the strand-summed depth; "A":
the annotation-strand-0 introns on one depth plane; "B": the strand-1
introns on the other) one fused pass computes, per intron, the int64 depth
sum, the nonzero-base count, the first- and last-window sums (the first and
last ``min(EDGE_DEPTH_WINDOW, n)`` included bases in genomic order) and the
three nearest-rank percentile bins of a ``cap``-bin histogram of the clipped
depth.  That pass is ``intron_stats``: the hand-written CUDA kernel
(kernels.intron_stats, csrc/stats.cu) on a CUDA tensor, the plain torch
composition ``intron_stats_plain`` on a CPU one.  It replaces the JAX
package's windowed gather (ops/gather.py gather_window, K3) and its
histogram scatter (ops/scatter.py hist_scatter_pallas, K4).

Only the packed ``(n_introns, 7)`` int64 rows leave the card, in one pinned
D2H; the host then runs ``_host_finish``'s float64 finish op for op, so the
statistics are bit-identical to finalize._depth_stats_vectorized.  Introns
whose percentile saturates the histogram (pk >= cap-1, n > 0) take the exact
host sort over just their bases, gathered from the card.

The sums are int64 throughout.  The JAX package sums in int32 and relies on
wraparound prefix differences, which is why it splits runs at RUN_SPLIT
bases; with int64 sums no split is needed.  Its band-overflow gather
metadata, histogram tile offsets and two-level prefix tables exist only for
the TPU kernels and have no counterpart here.

``irfinder_tpu.ops.finalize_stats`` imports jax, so its numpy helpers
``_subset_runs``, ``_ridx`` and ``_host_flat_src`` are copied here.

The subsets "A" and "B" carry every statistic on their own introns only
(zero elsewhere); finalize.intron_table reads each variant only on its own
introns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from irfinder_tpu import semantics as S
from irfinder_tpu.refio.compile import CompiledRef

from .. import kernels

#: histogram bins per intron (depths clip to [0, CAP-1]; saturated introns
#: take the exact host fallback)
CAP = 2048
#: intron-local window of the first/last-window means
EDGE = int(S.EDGE_DEPTH_WINDOW)
#: order of the subsets in the packed stats rows
SUBSET_ORDER = ("both", "A", "B")
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
class FinalizeRef:
    """Device-resident static finalize structure for one CompiledRef."""

    n_bases: np.ndarray  # (N,) int64
    subsets: dict  # "both" | "A" | "B" -> Subset


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
    fr = FinalizeRef(
        n_bases=n_bases,
        subsets={
            "both": _build_subset(ref, np.arange(ref.n_introns), n_bases, device),
            "A": _build_subset(ref, np.nonzero(istrand == 0)[0], n_bases, device),
            "B": _build_subset(ref, np.nonzero(istrand == 1)[0], n_bases, device),
        },
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


def intron_stats(depth: torch.Tensor, plane_sel: int, sub: Subset, cap: int, out: torch.Tensor) -> None:
    """Write the subset's (n_sub, 7) stats rows into ``out``: the CUDA kernel
    for a CUDA depth, the plain version for a CPU one."""
    if depth.is_cuda:
        kernels.intron_stats(depth, plane_sel, sub, cap, out)
    else:
        out.copy_(intron_stats_plain(depth, plane_sel, sub, cap))


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


def launch_all_stats(finref: FinalizeRef, depth: torch.Tensor, flip: bool, cap: int = CAP) -> torch.Tensor:
    """Every subset's stats rows, packed (sum of subset sizes, 7) int64 on
    depth's device in SUBSET_ORDER.  An empty subset launches nothing."""
    planes = subset_planes(flip)
    n_tot = sum(finref.subsets[k].size for k in SUBSET_ORDER)
    packed = torch.empty((n_tot, 7), dtype=torch.int64, device=depth.device)
    pos = 0
    for k in SUBSET_ORDER:
        sub = finref.subsets[k]
        if sub.size:
            intron_stats(depth, planes[k], sub, cap, packed[pos : pos + sub.size])
            pos += sub.size
    return packed


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
