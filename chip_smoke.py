#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (irfinder_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each one line of output; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: compile the CUDA kernels from csrc/ (nvcc, sm_90a).
3. kernels: each kernel against its plain PyTorch version on the card, bit
   for bit, on batches at the main path's shape (config A ref, cap_frags
   2**15, so 98,304 block lanes) and on a crafted edge batch; kernel and
   plain times after a warm-up, by CUDA events.
4. main path: ``run_bam`` on a ~1M-record BAM against the config-A ref on
   the card, with launch counts, wall and reads/s, then the counters and
   the tables against the C++ conformance counter (native/oracle) over the
   same decoded batches.
5. measure: WARM_RUNS warm ``run_bam`` runs with their stage timings, the
   finalize broken into its steps, ORACLE_RUNS more oracle runs, and the
   card's busy share over one run by torch.profiler.
6. The JSON kernel report, then the last line
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
#: repeats of the measurement phase: a single cold run says little about speed
WARM_RUNS = 5
ORACLE_RUNS = 3


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


def check_kernels(ref, dev) -> dict:
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
    """The port's finalized counters for ``bam`` (Engine on ``dev``)."""
    from irfinder_tpu_torch.engine import Engine, open_decoder
    from irfinder_tpu_torch.ops.step import finalize_device

    eng = Engine(ref, device=dev)
    header, batches, _ = open_decoder(ref, bam, CAP_FRAGS)
    eng.reset(n_refids=len(header.ref_names))
    eng.run_stream(batches)
    return {k: v.contiguous().cpu().numpy() for k, v in finalize_device(eng.dref, eng.counters).items()}


def measure(ref, bam: str, dev) -> None:
    """Warm repeats of the main path, its finalize step by step, the oracle
    again, and the card's busy share over one run by torch.profiler (device
    kernels and copies only, so nothing counts twice)."""
    from torch.profiler import ProfilerActivity, profile

    from irfinder_tpu_torch.conformance import (
        detect_directionality, intron_table, junction_counters, oracle_run,
    )
    from irfinder_tpu_torch.engine import Engine, open_decoder, run_bam
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
    fc = {k: v.contiguous().cpu().numpy() for k, v in fin.items()}
    steps["d2h"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc, ec, xc = junction_counters(ref, eng.junc_tally)
    _, flip, _, _ = detect_directionality(ref, xc)
    steps["junction_join"] = time.perf_counter() - t0
    args, cache = (ref, fc["depth"], sc, ec, xc, fc["span_hits"]), {}
    t0 = time.perf_counter()
    intron_table(*args, mode="nondir", stats_cache=cache)
    steps["intron_table_nondir"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    intron_table(*args, mode="dir", flip_strand=flip, stats_cache=cache)
    steps["intron_table_dir"] = time.perf_counter() - t0
    print("measure: finalize steps s " + " ".join(f"{k}={v:.6f}" for k, v in steps.items()))

    for i in range(ORACLE_RUNS):
        _, _, t_dec, t_orc = oracle_run(ref, bam, CAP_FRAGS)
        print(f"measure: oracle run {i}: decode {t_dec:.6f} s, count {t_orc:.6f} s, "
              f"count reads/s={m.reads_total / t_orc:.1f}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_bam(ref, bam, os.path.join(os.path.dirname(bam), "prof"), cap_frags=CAP_FRAGS, device=dev)
        wall = time.perf_counter() - t0
    items = sorted(((e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy_us = sum(us for us, _, _ in items)
    print(f"measure: profiled run wall={wall:.6f} s device busy={busy_us / 1e3:.6f} ms "
          f"({100 * busy_us / 1e6 / wall:.3f}% of wall); top device items (ms, count): "
          + "; ".join(f"{k[:60]} {us / 1e3:.6f} x{n}" for us, n, k in items[:6]))


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
    ptxas = " | ".join(ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln)
    print(f"build: {build_s:.3f} s nvcc ({ptxas or 'cached'})")

    ref = synth_ref(n_genes=N_GENES)
    print(f"ref: {ref.n_chroms} chrom, {ref.mbs_size} MBS bases, {ref.n_introns} introns, "
          f"{ref.uspan_start.size} spans, {ref.point_coord.size} points")
    kres = check_kernels(ref, dev)

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

        ofc, header, t_dec, t_orc = oracle_run(ref, bam, CAP_FRAGS)
        print(f"oracle: decode {t_dec:.6f} s, count {t_orc:.6f} s, "
              f"count reads/s={m.reads_total / t_orc:.1f}, decode+count reads/s="
              f"{m.reads_total / (t_dec + t_orc):.1f}")
        pfc = port_counters(ref, bam, dev)
        for k in ("depth", "span_hits", "roi_cnt", "chr_frag", "n_frags"):
            if not np.array_equal(np.asarray(ofc[k]).astype(np.int64), pfc[k].astype(np.int64)):
                raise AssertionError(f"counter {k} differs from the oracle")
        print(f"counters: depth span_hits roi_cnt chr_frag n_frags integer-identical to the "
              f"oracle (n_frags={int(pfc['n_frags'])}, depth sum={int(pfc['depth'].sum())})")
        for name, text in oracle_tables(ref, header, ofc).items():
            with open(os.path.join(out, name)) as fh:
                if fh.read() != text:
                    raise AssertionError(f"{name} differs from the oracle's")
        print("tables: IR-nondir IR-dir SpansPoint ROI ChrCoverage byte-identical to the oracle's")
        measure(ref, bam, dev)

    print(json.dumps({"kernels": [{
        "name": "count_blocks",
        "route": "cuda",
        "source": "irfinder_tpu_torch/csrc/count.cu",
        "replaces": "irfinder_tpu/ops/pallas_rank.py:385 + irfinder_tpu/ops/scatter.py:107",
        "launches": launched["count_blocks"],
        "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"],
        "plain_ms": kres["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
