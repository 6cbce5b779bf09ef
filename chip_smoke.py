#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (irfinder_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each one or more lines of output; any failure raises and exits
non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: compile the CUDA kernels from csrc/ (one nvcc, sm_90a, into one
   library).
3. kernels (count): ``count_blocks`` against its plain PyTorch version on the
   card, bit for bit, on batches at the main path's shape (config A ref,
   cap_frags 2**15, so 98,304 block lanes) and on a crafted edge batch;
   kernel and plain times by CUDA events and by torch.profiler.
4. main path, config A: ``run_bam`` on a ~1M-record BAM against the config-A
   ref on the card, with launch counts (both kernels), wall and reads/s,
   then the counters and the tables against the C++ conformance counter
   (native/oracle) over the same decoded batches.
5. kernels (stats): ``intron_stats`` against ``intron_stats_plain`` on the
   card, bit for bit, on every subset with the flip both ways, at cap 2048
   and cap 4, on the real config-A depth, a random depth and a hot depth
   (> 2047, so the saturated fallback runs); at the largest cap the kernel's
   shared memory takes (equal to plain) and one past it (refused); the whole
   device statistics on the hot depth against the plain path on the CPU and
   the host path; kernel and plain times by CUDA events and by
   torch.profiler.
6. batch, config D: ``run_multi_bam`` over 8 BAMs (~8.1M records), launch
   counts, every sample's tables against a solo run and the oracle's, then
   BATCH_WARM_RUNS warm runs with the aggregate reads/s.
7. measure: WARM_RUNS warm ``run_bam`` runs with their stage timings, the
   finalize broken into its steps, ORACLE_RUNS more oracle runs, and one run
   under torch.profiler: the card's busy share and every D2H copy's size
   (none in the finalize may reach 1 MB: the depth stays on the card).
8. The JSON kernel report, then the last line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA card; exits non-zero without one.  Imports only torch, numpy
and irfinder_tpu_torch (never JAX).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: config A (BASELINE.md): the chr21-scale synthetic map and ~1M reads
N_GENES = 800
N_PAIRS = 500_000
CAP_FRAGS = 1 << 15
SEED = 0
#: config D (BASELINE.md): N_SAMPLES config-A-sized BAMs, seeds 0..N-1
N_SAMPLES = 8
#: repeats of the measurement phase: a single cold run says little about speed
WARM_RUNS = 5
ORACLE_RUNS = 3
BATCH_WARM_RUNS = 3
#: a hot depth: above the 2,048-bin histogram, so the exact fallback runs
HOT = 2100
#: no finalize D2H may reach this many bytes
D2H_LIMIT = 1 << 20
TABLES = (
    "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt", "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt", "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    "WARNINGS",
)


def require_card() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    return torch.cuda.get_device_name(0)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def edge_batch(ref, B: int, rng) -> dict:
    """Pad lanes, chrom -1, a chrom id past the table, blocks shorter than
    2*OH, both strands, blocks whose end-OH falls before the first point,
    blocks at span and point edges, and hot-spot duplicates."""
    from irfinder_tpu_torch.ops.step import OVERHANG as OH

    n_chroms = len(ref.chroms)
    c = rng.integers(-1, n_chroms + 1, B).astype(np.int32)
    s = rng.integers(0, int(ref.uspan_end.max()) + 1000, B).astype(np.int32)
    e = (s + rng.integers(0, 3 * OH, B)).astype(np.int32)  # many < 2*OH
    st = rng.integers(0, 2, B).astype(np.int32)
    q = B // 8
    first_pt = int(ref.point_coord.min())
    s[:q], e[:q], c[:q] = 0, min(first_pt, 2 * OH + 1), 0  # e - OH before the first point
    k = min(q, ref.uspan_start.size)
    s[q : q + k], e[q : q + k], c[q : q + k] = ref.uspan_start[:k], ref.uspan_end[:k], 0
    pts = ref.point_coord[rng.integers(0, ref.point_coord.size, q)]
    s[2 * q : 3 * q], e[2 * q : 3 * q], c[2 * q : 3 * q] = pts - OH, pts + OH, 0
    s[3 * q : 4 * q], e[3 * q : 4 * q], c[3 * q : 4 * q] = 5000, 5300, 0  # hot spot
    c[4 * q : 5 * q] = -1  # explicit pad lanes
    return {"blk_chrom": c, "blk_start": s, "blk_end": e, "blk_strand": st}


def time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check_count_kernel(ref, dev) -> dict:
    """count_blocks vs count_blocks_plain on the card, bit for bit."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.conformance import synth_batch_arrays
    from irfinder_tpu_torch.ops.device_ref import build_device_ref
    from irfinder_tpu_torch.ops.step import OVERHANG as OH
    from irfinder_tpu_torch.ops.step import CounterLayout, count_blocks_plain

    dref = build_device_ref(ref, dev)
    lay = CounterLayout.build(dref)
    rng = np.random.default_rng(SEED)
    cases = []
    for seed in (1, 2):
        arrays, _ = synth_batch_arrays(ref, n_frags=CAP_FRAGS, seed=seed)
        cases.append((f"synth{seed}", arrays))
    B = cases[0][1]["blk_chrom"].shape[0]
    cases.append(("edge", edge_batch(ref, B, rng)))
    worst = 0
    for name, arrays in cases:
        cols = [torch.from_numpy(np.ascontiguousarray(arrays[k], np.int32)).to(dev)
                for k in ("blk_chrom", "blk_start", "blk_end", "blk_strand")]
        got = torch.zeros(lay.total, dtype=torch.int32, device=dev)
        want = torch.zeros_like(got)
        kernels.count_blocks(dref, got, *cols, lay, OH)
        count_blocks_plain(dref, want, *cols, lay, OH)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        touched = int(torch.count_nonzero(want).item())
        print(f"kernels: count_blocks vs plain on {name} (B={B}): max_abs_err={err} "
              f"nonzero_slots={touched} equal={torch.equal(got, want)}")
        if not torch.equal(got, want) or touched == 0:
            raise AssertionError(f"count_blocks disagrees with its plain version on {name}")
        worst = max(worst, err)
    # times at the main path's shape (first synth batch), cnt accumulating
    cols = [torch.from_numpy(np.ascontiguousarray(cases[0][1][k], np.int32)).to(dev)
            for k in ("blk_chrom", "blk_start", "blk_end", "blk_strand")]
    scratch = torch.zeros(lay.total, dtype=torch.int32, device=dev)
    plain_ms = time_ms(lambda: count_blocks_plain(dref, scratch, *cols, lay, OH), 20)
    ms = time_ms(lambda: kernels.count_blocks(dref, scratch, *cols, lay, OH), 50)
    plain_ms2 = time_ms(lambda: count_blocks_plain(dref, scratch, *cols, lay, OH), 20)
    ms2 = time_ms(lambda: kernels.count_blocks(dref, scratch, *cols, lay, OH), 50)
    print(f"kernels: count_blocks B={B} ms/call by CUDA events kernel={ms:.6f},{ms2:.6f} "
          f"plain={plain_ms:.6f},{plain_ms2:.6f} (plain, kernel, plain, kernel)")
    k_dev = device_ms(lambda: kernels.count_blocks(dref, scratch, *cols, lay, OH))
    p_dev = device_ms(lambda: count_blocks_plain(dref, scratch, *cols, lay, OH))
    print(f"kernels: count_blocks B={B} device ms/call by torch.profiler kernel={k_dev} plain={p_dev}")
    return {"max_abs_err": worst, "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2)}


def device_ms(fn, reps: int = 20) -> str:
    """Summed device time of every kernel and copy ``fn`` runs, per call, from
    a torch.profiler trace (launch overhead on the host excluded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return f"{us / 1e3 / reps:.6f}" if us else "not measured"


def port_counters(ref, bam: str, dev) -> dict:
    """The port's finalized counters for ``bam`` (Engine on ``dev``), as
    tensors on the card."""
    from irfinder_tpu_torch.engine import Engine, open_decoder
    from irfinder_tpu_torch.ops.step import finalize_device

    eng = Engine(ref, device=dev)
    header, batches, _ = open_decoder(ref, bam, CAP_FRAGS)
    eng.reset(n_refids=len(header.ref_names))
    eng.run_stream(batches)
    return finalize_device(eng.dref, eng.counters)


def own_introns(ref, flip: bool) -> dict:
    """stats variant -> the introns intron_table reads it on."""
    ist = ref.intron_strand.astype(np.int64)
    pa = 1 if flip else 0
    return {2: np.arange(ref.n_introns), pa: np.nonzero(ist == 0)[0], 1 - pa: np.nonzero(ist == 1)[0]}


def run_subsets(fn, finref, depth, flip: bool, cap: int) -> torch.Tensor:
    """Every subset's stats rows through ``fn`` (the kernel wrapper or the
    plain version), packed as the engine packs them."""
    from irfinder_tpu_torch.ops import finalize_stats as FS

    planes = FS.subset_planes(flip)
    subs = [finref.subsets[k] for k in FS.SUBSET_ORDER]
    out = torch.empty((sum(s_.size for s_ in subs), 7), dtype=torch.int64, device=depth.device)
    pos = 0
    for k, sub in zip(FS.SUBSET_ORDER, subs):
        if sub.size:
            fn(depth, planes[k], sub, cap, out[pos : pos + sub.size])
            pos += sub.size
    return out


def plain_stats(depth, sel, sub, cap, out) -> None:
    from irfinder_tpu_torch.ops.finalize_stats import intron_stats_plain

    out.copy_(intron_stats_plain(depth, sel, sub, cap))


def check_stats_kernel(ref, real_depth, dev) -> dict:
    """intron_stats vs intron_stats_plain on the card, bit for bit; the whole
    device statistics against the CPU plain path and the host path."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.conformance import depth_stats_host
    from irfinder_tpu_torch.ops import finalize_stats as FS

    finref = FS.build_finalize_ref(ref, dev)
    print("kernels: intron_stats subsets " + " ".join(
        f"{k}: {finref.subsets[k].size} introns {int(finref.subsets[k].n_bases.sum())} bases"
        for k in FS.SUBSET_ORDER))
    rng = np.random.default_rng(SEED + 1)
    rand = rng.integers(0, 7, size=(2, ref.mbs_size)).astype(np.int32)
    rand[rng.random((2, ref.mbs_size)) < 0.3] = 0  # coverage gaps
    hot = rand.copy()
    hot[:, : ref.mbs_size // 2] += HOT
    cases = {"real": real_depth, "random": torch.from_numpy(rand).to(dev),
             "hot": torch.from_numpy(hot).to(dev)}
    worst = 0
    for name, depth in cases.items():
        for flip in (False, True):
            for cap in (FS.CAP, 4):
                got = run_subsets(kernels.intron_stats, finref, depth, flip, cap)
                want = run_subsets(plain_stats, finref, depth, flip, cap)
                torch.cuda.synchronize()
                err = int((got - want).abs().max().item())
                eq = torch.equal(got, want)
                print(f"kernels: intron_stats vs plain on {name} depth flip={flip} cap={cap} "
                      f"rows={got.shape[0]} max_abs_err={err} equal={eq}")
                if not eq:
                    raise AssertionError(f"intron_stats disagrees with its plain version on {name}")
                worst = max(worst, err)

    # the histogram's limit: the largest cap launches and agrees, one more raises
    mx = kernels.intron_stats_max_cap()
    got = run_subsets(kernels.intron_stats, finref, cases["hot"], False, mx)
    want = run_subsets(plain_stats, finref, cases["hot"], False, mx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"intron_stats disagrees with its plain version at cap={mx}")
    try:
        run_subsets(kernels.intron_stats, finref, cases["hot"], False, mx + 1)
    except ValueError:
        pass
    else:
        raise AssertionError(f"intron_stats took cap={mx + 1}, past its shared-memory limit")
    print(f"kernels: intron_stats at its largest cap={mx} equal to plain on the hot depth; "
          f"cap={mx + 1} refused")
    del got, want

    cpu_fr = FS.build_finalize_ref(ref, "cpu")
    n_sat = 0
    for name, cap in (("hot", FS.CAP), ("random", 4)):
        d_np = cases[name].cpu().numpy()
        for flip in (False, True):
            info = {}
            got = FS.device_all_stats(ref, finref, cases[name], flip, cap=cap, info=info)
            want = FS.device_all_stats(ref, cpu_fr, cases[name].cpu(), flip, cap=cap)
            for v, introns in own_introns(ref, flip).items():
                host = depth_stats_host(ref, (d_np[0] + d_np[1] if v == 2 else d_np[v]).astype(np.int64))
                for g, w, h in zip(got[v], want[v], host):
                    if not np.array_equal(g, w) or not np.array_equal(g[introns], h[introns]):
                        raise AssertionError(f"device statistics differ on {name} flip={flip} variant {v}")
            print(f"kernels: device_all_stats on {name} depth flip={flip} cap={cap}: saturated "
                  f"introns taking the exact fallback={info['saturated']}; equal to the CPU plain "
                  f"path and to the host path on every variant")
            if info["saturated"] == 0:
                raise AssertionError(f"the saturated fallback did not run on {name}")
            if cap == FS.CAP:
                n_sat = max(n_sat, info["saturated"])

    depth = cases["real"]

    def kern():
        run_subsets(kernels.intron_stats, finref, depth, False, FS.CAP)

    def plain():
        run_subsets(plain_stats, finref, depth, False, FS.CAP)

    plain_ms = time_ms(plain, 10)
    ms = time_ms(kern, 50)
    plain_ms2 = time_ms(plain, 10)
    ms2 = time_ms(kern, 50)
    print(f"kernels: intron_stats, 3 subsets on the real depth, ms per finalize by CUDA events "
          f"kernel={ms:.6f},{ms2:.6f} plain={plain_ms:.6f},{plain_ms2:.6f} (plain, kernel, plain, kernel)")
    print(f"kernels: intron_stats, 3 subsets, device ms per finalize by torch.profiler "
          f"kernel={device_ms(kern)} plain={device_ms(plain)}")
    return {"max_abs_err": worst, "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
            "saturated": n_sat}


def check_oracle_tables(ref, bam: str, out: str) -> None:
    """The IR, SpansPoint, ROI and ChrCoverage tables in ``out`` against the
    ones rendered from native/oracle's counters for ``bam``."""
    from irfinder_tpu_torch.conformance import oracle_run, oracle_tables

    ofc, header, _, _ = oracle_run(ref, bam, CAP_FRAGS)
    for name, text in oracle_tables(ref, header, ofc).items():
        with open(os.path.join(out, name)) as fh:
            if fh.read() != text:
                raise AssertionError(f"{out}: {name} differs from the oracle's")


def read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def batch_phase(ref, bam0: str, tmp: str, dev) -> None:
    """Config D: run_multi_bam over N_SAMPLES BAMs on the card, checked per
    sample against a solo run and the oracle, then timed warm."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.conformance import write_realistic_bam
    from irfinder_tpu_torch.engine import run_bam, run_multi_bam

    bams = [bam0]
    t0 = time.perf_counter()
    n_rec = 0
    for i in range(1, N_SAMPLES):
        bams.append(os.path.join(tmp, f"configD_{i}.bam"))
        n_rec += write_realistic_bam(bams[-1], ref, n_pairs=N_PAIRS, seed=SEED + i).n_records
    print(f"batch: {N_SAMPLES - 1} more BAMs, {n_rec} records, written in "
          f"{time.perf_counter() - t0:.3f} s")
    outs = [os.path.join(tmp, "batch", f"s{i}") for i in range(N_SAMPLES)]
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ms = run_multi_bam(ref, bams, outs, cap_frags=CAP_FRAGS, device=dev)
    wall = time.perf_counter() - t0
    launched = dict(kernels.launches)
    reads = sum(m.reads_total for m in ms)
    batches = sum(m.batches for m in ms)
    print(f"batch: run_multi_bam over {N_SAMPLES} BAMs wall={wall:.6f} s reads={reads} "
          f"reads/s={reads / wall:.1f} batches={batches} multi_stream_s={ms[0].multi_stream_s:.6f} "
          f"multi_finalize_s={ms[0].multi_finalize_s:.6f} launches={launched}")
    if launched["count_blocks"] != batches or launched["intron_stats"] < N_SAMPLES:
        raise AssertionError(f"batch launches {launched} for {batches} batches")
    for i, bam in enumerate(bams):
        solo = os.path.join(tmp, "solo", f"s{i}")
        run_bam(ref, bam, solo, cap_frags=CAP_FRAGS, device=dev)
        for name in TABLES:
            if read(os.path.join(outs[i], name)) != read(os.path.join(solo, name)):
                raise AssertionError(f"sample {i}: {name} differs between batch and solo")
        check_oracle_tables(ref, bam, outs[i])
    print(f"batch: every sample's {len(TABLES)} tables byte-identical to its solo run, and its "
          f"IR-nondir IR-dir SpansPoint ROI ChrCoverage to the oracle's")
    walls = []
    for r in range(BATCH_WARM_RUNS):
        t0 = time.perf_counter()
        ms = run_multi_bam(ref, bams, outs, cap_frags=CAP_FRAGS, device=dev)
        walls.append(time.perf_counter() - t0)
        print(f"batch: warm run {r}: wall={walls[-1]:.6f} s aggregate reads/s={reads / walls[-1]:.1f} "
              f"multi_stream_s={ms[0].multi_stream_s:.6f} "
              f"multi_finalize_s={ms[0].multi_finalize_s:.6f} "
              f"decode_s(sum)={sum(m.decode_s for m in ms):.6f}")
    med = float(np.median(walls))
    print(f"batch: {BATCH_WARM_RUNS} warm runs: median wall={med:.6f} s "
          f"aggregate reads/s={reads / med:.1f}")


def d2h_copies(trace_path: str) -> list:
    """Bytes of every device-to-host copy in a torch.profiler chrome trace."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    out = []
    for e in events:
        if e.get("cat") == "gpu_memcpy" and "DtoH" in e.get("name", ""):
            args = e.get("args", {})
            if "bytes" not in args:
                raise AssertionError(f"D2H trace event without a byte count: {e}")
            out.append(int(args["bytes"]))
    return out


def measure(ref, bam: str, dev) -> None:
    """Warm repeats of the main path, its finalize step by step, the oracle
    again, and one run under torch.profiler: the card's busy share (device
    kernels and copies only, so nothing counts twice) and the D2H sizes."""
    from torch.profiler import ProfilerActivity, profile

    from irfinder_tpu_torch.conformance import (
        detect_directionality, intron_table, junction_counters, oracle_run,
    )
    from irfinder_tpu_torch.engine import Engine, open_decoder, run_bam
    from irfinder_tpu_torch.ops import finalize_stats as FS
    from irfinder_tpu_torch.ops.step import finalize_device

    walls = []
    for i in range(WARM_RUNS):
        t0 = time.perf_counter()
        m = run_bam(ref, bam, os.path.join(os.path.dirname(bam), f"warm{i}"),
                    cap_frags=CAP_FRAGS, device=dev)
        wall = time.perf_counter() - t0
        walls.append(wall)
        print(f"measure: warm run {i}: wall={wall:.6f} s reads/s={m.reads_total / wall:.1f} "
              f"decode_s={m.decode_s:.6f} h2d_s={m.h2d_s:.6f} device_s={m.device_s:.6f} "
              f"sync_s={m.sync_s:.6f} finalize_s={m.finalize_s:.6f}")
    q1, med, q3 = np.percentile(walls, [25, 50, 75])
    print(f"measure: {WARM_RUNS} warm runs: median wall={med:.6f} s "
          f"reads/s={m.reads_total / med:.1f} quartiles={q1:.6f}-{q3:.6f} s")

    eng = Engine(ref, device=dev)
    header, batches, _ = open_decoder(ref, bam, CAP_FRAGS)
    eng.reset(n_refids=len(header.ref_names))
    steps = {}
    t0 = time.perf_counter()
    eng.run_stream(batches)
    steps["stream"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fin = finalize_device(eng.dref, eng.counters)
    torch.cuda.synchronize(dev)
    steps["finalize_device"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc, ec, xc = junction_counters(ref, eng.junc_tally)
    _, flip, _, _ = detect_directionality(ref, xc)
    steps["junction_join"] = time.perf_counter() - t0
    finref = FS.build_finalize_ref(ref, dev)
    t0 = time.perf_counter()
    packed = FS.launch_all_stats(finref, fin["depth"], flip)
    torch.cuda.synchronize(dev)
    steps["device_stats"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = FS.pull_async(packed)()
    steps["stats_d2h"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fc = {k: FS.pull_async(v.contiguous())() for k, v in fin.items() if k != "depth"}
    steps["small_d2h"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cache = FS.finish_all_stats(ref, finref, fin["depth"], flip, rows)
    steps["host_finish"] = time.perf_counter() - t0
    args = (ref, None, sc, ec, xc, fc["span_hits"])
    t0 = time.perf_counter()
    intron_table(*args, mode="nondir", stats_cache=cache)
    steps["intron_table_nondir"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    intron_table(*args, mode="dir", flip_strand=flip, stats_cache=cache)
    steps["intron_table_dir"] = time.perf_counter() - t0
    print("measure: finalize steps s " + " ".join(f"{k}={v:.6f}" for k, v in steps.items())
          + f" (stats rows {rows.nbytes} bytes)")

    for i in range(ORACLE_RUNS):
        _, _, t_dec, t_orc = oracle_run(ref, bam, CAP_FRAGS)
        print(f"measure: oracle run {i}: decode {t_dec:.6f} s, count {t_orc:.6f} s, "
              f"count reads/s={m.reads_total / t_orc:.1f}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mp = run_bam(ref, bam, os.path.join(os.path.dirname(bam), "prof"),
                     cap_frags=CAP_FRAGS, device=dev)
        wall = time.perf_counter() - t0
    items = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_us = sum(us for us, _, _ in items)
    print(f"measure: profiled run wall={wall:.6f} s finalize_s={mp.finalize_s:.6f} "
          f"device busy={busy_us / 1e3:.6f} ms ({100 * busy_us / 1e6 / wall:.3f}% of wall); "
          "top device items (ms, count): "
          + "; ".join(f"{k[:60]} {us / 1e3:.6f} x{n}" for us, n, k in items[:8]))
    trace = os.path.join(os.path.dirname(bam), "trace.json")
    prof.export_chrome_trace(trace)
    d2h = d2h_copies(trace)
    print(f"measure: profiled run D2H copies={len(d2h)} bytes={sorted(d2h, reverse=True)}")
    if not d2h or max(d2h) >= D2H_LIMIT:
        raise AssertionError(f"a finalize D2H of {max(d2h, default=0)} bytes (limit {D2H_LIMIT})")


def main() -> int:
    kind = require_card()
    # the port's imports come after the card check and before any result:
    # run without the repository, they fail here
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.conformance import (
        native_decoder, oracle_run, oracle_tables, synth_ref, write_realistic_bam,
    )
    from irfinder_tpu_torch.engine import run_bam

    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print(f"device: torch={kind} count={torch.cuda.device_count()} torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    _, build_s, log = kernels.build(verbose=True)
    ptxas = " | ".join(ln.strip() for ln in log.splitlines()
                       if "Compiling entry" in ln or "registers" in ln or "spill" in ln)
    print(f"build: {build_s:.3f} s nvcc wall, {len(kernels.SOURCES)} sources in one nvcc "
          f"({ptxas or 'cached'})")

    ref = synth_ref(n_genes=N_GENES)
    print(f"ref: {ref.n_chroms} chrom, {ref.mbs_size} MBS bases, {ref.n_introns} introns, "
          f"{ref.uspan_start.size} spans, {ref.point_coord.size} points, {ref.run_len.size} runs")
    cres = check_count_kernel(ref, dev)

    with tempfile.TemporaryDirectory() as tmp:
        bam = os.path.join(tmp, "configA.bam")
        t0 = time.perf_counter()
        mix = write_realistic_bam(bam, ref, n_pairs=N_PAIRS, seed=SEED)
        print(f"bam: {mix.n_records} records written in {time.perf_counter() - t0:.3f} s")
        decoder = native_decoder()

        out = os.path.join(tmp, "out")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        m = run_bam(ref, bam, out, cap_frags=CAP_FRAGS, device=dev)
        wall = time.perf_counter() - t0
        launched = dict(kernels.launches)
        print(f"main path: run_bam wall={wall:.6f} s reads={m.reads_total} "
              f"reads/s={m.reads_total / wall:.1f} batches={m.batches} "
              f"decode_s={m.decode_s:.6f} h2d_s={m.h2d_s:.6f} device_s={m.device_s:.6f} "
              f"sync_s={m.sync_s:.6f} finalize_s={m.finalize_s:.6f} decoder={decoder} "
              f"metrics.device={m.device!r} launches={launched} "
              f"peak_mem_bytes={torch.cuda.max_memory_allocated(dev)}")
        if launched["count_blocks"] != m.batches or m.batches == 0:
            raise AssertionError(f"count_blocks launched {launched} for {m.batches} batches")
        if launched["intron_stats"] == 0:
            raise AssertionError(f"intron_stats never launched on the main path: {launched}")

        ofc, header, t_dec, t_orc = oracle_run(ref, bam, CAP_FRAGS)
        print(f"oracle: decode {t_dec:.6f} s, count {t_orc:.6f} s, "
              f"count reads/s={m.reads_total / t_orc:.1f}, decode+count reads/s="
              f"{m.reads_total / (t_dec + t_orc):.1f}")
        pfc = port_counters(ref, bam, dev)
        for k in ("depth", "span_hits", "roi_cnt", "chr_frag", "n_frags"):
            got = pfc[k].contiguous().cpu().numpy().astype(np.int64)
            if not np.array_equal(np.asarray(ofc[k]).astype(np.int64), got):
                raise AssertionError(f"counter {k} differs from the oracle")
        print(f"counters: depth span_hits roi_cnt chr_frag n_frags integer-identical to the "
              f"oracle (n_frags={int(pfc['n_frags'])}, depth sum={int(pfc['depth'].sum())})")
        for name, text in oracle_tables(ref, header, ofc).items():
            with open(os.path.join(out, name)) as fh:
                if fh.read() != text:
                    raise AssertionError(f"{name} differs from the oracle's")
        print("tables: IR-nondir IR-dir SpansPoint ROI ChrCoverage byte-identical to the oracle's")

        sres = check_stats_kernel(ref, pfc["depth"], dev)
        del pfc
        batch_phase(ref, bam, tmp, dev)
        measure(ref, bam, dev)

    print(json.dumps({"kernels": [{
        "name": "count_blocks",
        "route": "cuda",
        "source": "irfinder_tpu_torch/csrc/count.cu",
        "replaces": "irfinder_tpu/ops/pallas_rank.py:385 + irfinder_tpu/ops/scatter.py:107",
        "launches": launched["count_blocks"],
        "max_abs_err": cres["max_abs_err"],
        "ms": cres["ms"],
        "plain_ms": cres["plain_ms"],
    }, {
        "name": "intron_stats",
        "route": "cuda",
        "source": "irfinder_tpu_torch/csrc/stats.cu",
        "replaces": "irfinder_tpu/ops/gather.py:95 + irfinder_tpu/ops/scatter.py:233",
        "launches": launched["intron_stats"],
        "max_abs_err": sres["max_abs_err"],
        "ms": sres["ms"],
        "plain_ms": sres["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
