#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (irfinder_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each one or more lines of output; any failure raises and exits
non-zero:

1. device: the card's name and power limit (nvidia-smi).
2. build: compile the CUDA kernels from csrc/ (sm_90a, one nvcc per source,
   all started together, one library each).
3. kernels (count): ``count_step`` (the whole count step in one launch)
   against its plain PyTorch version ``count_step_plain`` on the card, bit
   for bit on ``cnt`` and ``chr``: two synthetic batches at the main path's
   shape (config A ref, cap_frags 2**15, so 98,304 block lanes and 32,768
   fragment lanes), a crafted edge batch (blocks and fragments), tables on
   every search-tree level boundary (16**k - 1, 16**k, 16**k + 1 keys), a
   300-refid header with 70 ROI rows (tallies past the kernel's shared
   ones, added in global memory), a whole-genome-sized map (24 chroms, ~2.4
   GB of counters), and the mesh's padded genome-shard tables of that map
   and of config A's at genome=4 (three of those empty); the old
   one-batch-repeated times.  Once the BAM is written: every decoded batch of
   config A, accumulated, the kernel and plain times over those batches in
   turn, the share of block lanes whose pairs the kernel skips, and the
   bound.
4. main path, config A: ``run_bam`` on a ~1M-record BAM against the config-A
   ref on the card, with launch counts (``count_step`` once per batch,
   ``intron_stats`` once per finalize), wall and reads/s,
   then the counters and the tables against the C++ conformance counter
   (native/oracle) over the same decoded batches.
5. kernels (stats): ``intron_stats`` (one launch for all three subsets)
   against ``all_stats_plain`` on the card, bit for bit, with the flip both
   ways, at cap 2048 and cap 4, on the real config-A depth, a random depth
   and a hot depth (> 2047, so the saturated fallback runs); at the largest
   cap the kernel's shared memory takes (equal to plain) and one past it
   (refused); with forced small chunks, so that every intron splits across
   work items; on a synthetic run table of introns from 1 to 300,000 bases
   (default chunk and a small one); one launch over several samples
   (``launch_all_stats_multi``) against single launches and
   ``all_stats_multi_plain``, bit for bit, with mixed polarity: the real,
   random and hot depths (N = 3), forced splits (chunk 1 and 97), three
   long-intron-table depths, and N = 1; the whole device statistics on the
   hot depth against the plain path on the CPU and the host path; kernel
   and plain times by CUDA events and by torch.profiler, and the bytes and
   the time its bound counts.
6. batch, config D: ``run_multi_bam`` over 8 BAMs (~8.1M records), launch
   counts (``intron_stats`` once for all samples: the batched finalize),
   every sample's tables against a solo run and the oracle's; the 8 depths
   in one ``intron_stats`` launch against 8 single launches (bit for bit,
   mixed polarity) and timed against them in turns, beside the bound; then
   BATCH_WARM_RUNS warm runs with the aggregate reads/s, in turns with the
   one-sample-at-a-time finalize (tables equal).
6b. fastq: config A's BAM through ``cli.main(["FastQ", ..., "--device",
   "cuda"])`` off a stand-in aligner (a script that cats it), spooled, with
   ``--stream --keep-bam`` and with ``--trim`` on a few reads, one carrying
   an adapter; tables byte-identical to config A's ``run_bam``, the teed
   Unsorted.bam to the input, launch counts per run; the ``--stream`` wall
   against ``run_bam``'s, in turns.
7. measure: WARM_RUNS warm ``run_bam`` runs with their stage timings, one
   more with every span of its phases (RunMetrics.spans), ORACLE_RUNS more oracle runs, and one run
   under torch.profiler: the card's busy share and every D2H copy's size
   (none in the finalize may reach 1 MB: the depth stays on the card); in
   that run the count kernel must run once per batch, with no ``index_add_``
   anywhere, and its device time per launch is the kernel's primary figure.
7b. checkpoint, whole genome: a BAM of WG_PAIRS pairs against the
   whole-genome-sized map; ``run_bam`` uninterrupted (wall, reads/s,
   finalize_s, launches), its counters and tables against the oracle's,
   ``intron_stats`` against its plain version and its time on that depth,
   one more run's spans (RunMetrics.spans: open, stream, the finalize's
   parts, each table's write); a
   run under the snapshot cadence; half the batches counted, then
   snapshots by the card pack and the host pack in turns (seconds by pack,
   D2H and write; bytes; escapes), load and restore seconds; the resumed
   run (its ``count_step`` launches exactly the batches after the snapshot,
   its inflated BGZF blocks against the full run's) and the resume of a
   snapshot without a token, both byte-identical to the uninterrupted run.
7b'. cohort: batch mode over a whole-genome cohort, COHORT_SAMPLES BAMs of
   COHORT_PAIRS pairs against the whole-genome map through
   ``run_multi_bam``: its depth rows pass MULTI_STATS_BUDGET, so the
   samples finalize one at a time (``intron_stats`` once per sample); the
   peak device memory below every sample's counters and depth rows at once;
   every sample's tables byte-identical to its solo ``run_bam``.
7c. mesh: the dp x genome mesh (engine_mesh.run_bam_mesh), cell i on
   cuda:(i % the card count), the cell -> card map printed.  Config A at
   dp=2, dp=2,genome=4, dp=2,genome=4,routed and dp=4,genome=2,routed, with
   an unsharded run_bam before and after: tables byte-identical to config
   A's run_bam, ``count_step`` launched cells x batches times and
   ``intron_stats`` once, the wall, the route span and the routed padding.  The
   whole-genome map at genome=4,routed: tables byte-identical to phase 7b's
   uninterrupted run, wall, finalize_s and peak memory beside the unsharded
   run's, and ``intron_stats`` on the reassembled depth against its plain
   version and by CUDA events.  A mesh snapshot at config A,
   dp=2,genome=4,routed, after half the batches, and its resume (launches:
   cells x the batches after it).  ``cli.main(["BAM", ..., "--mesh",
   "genome=4"])`` with the default devices (unsharded on fewer than 4
   cards).  The multi-process path (multihost.run_bam_multihost): one rank
   per card under NCCL, each a routed genome=2 mesh counting its
   round-robin share of config A's batches; after the merge rank 0's tables
   are byte-identical to config A's run_bam.
7d. cli: the user's workflow, every step through ``cli.main``.  BuildRef off
   a GTF written from the whole-genome map's exons, with its ROIs as a BED:
   the loaded reference field for field equal to the map; BuildRefProcess
   and BuildRefFromSTARRef on config A's GTF (ref.json byte-identical,
   fields equal to config A's map).  ``BAM --device cuda`` off the built
   whole-genome reference: tables byte-identical to phase 7b's run,
   ``count_step`` once per batch, ``intron_stats`` once.  ``Batch --a
   0,1,2,3 --b 4,5,6,7 --device cuda`` over config D's BAMs off the built
   config A reference (``intron_stats`` once): every sample's tables
   byte-identical to phase 6's,
   then ``Diff`` byte-identical to Batch's differential.  ``ExportGLM``
   (nondir and --dir) held to the tables it reads; ``Goldens`` pinned
   against phase 7b, and exit 1 naming the line, column and constants on a
   copy with one IntronDepth changed.  Mapability (host work) at MAP_LEN
   bases: generate, a stand-in aligner BAM (io/bamwrite), collect (the BED
   exactly both copies of the planted duplicate and the N run), BuildRef
   --exclude with it.  BuildRefDownload without and with a manifest.  Each
   step's wall and the phase's.
7e. long reads and the library API.  The long-read workload of
   bench/longread_throughput.py: LONG_READS single-end ONT/PacBio-shaped
   reads (16, 48 or 96 exon blocks over 10-100 kb, seed 5) against config
   A's map, in the long-read batch geometry (64 blocks and gaps per
   fragment: 2,097,152 block lanes and 32,768 fragment lanes a launch) and
   in the paired one.  In each geometry: ``count_step`` against
   ``count_step_plain`` on the first two decoded batches, bit for bit; every
   batch's real and pad lanes and the bound; ``run_bam(config=
   RunConfig(long_reads=...))`` (launches: ``count_step`` once per batch,
   ``intron_stats`` once), LONG_WARM_RUNS warm runs with their stages, and
   one under torch.profiler (``count_step``'s device time per launch beside
   its bound).  The two geometries' tables byte-identical to each other and
   to the oracle's over the long-read batches; ``cli.main(["BAM",
   "--long-reads", "--device", "cuda", ...])`` byte-identical to them.  Then
   the batch-by-batch library API on config A: ``Engine(ref,
   cap_frags=2**15).process_batch`` over its decoded batches (``count_step``
   once each), ``counters_host()`` integer-identical to the oracle's
   counters, ``results()``'s tables byte-identical to phase 4's,
   ``results(fc)`` on the host counters (exactly one more ``intron_stats``,
   equal rows).
8. The JSON kernel report (each kernel's launches on the main path and on
   each batch, mesh, CLI, long-read and library card path, ``intron_stats``'
   eight-sample launch at config D, ``count_step``'s time
   and bound in each long-read geometry, error, times, and the bound: the
   larger of its bytes over 3.35 TB/s and its operations over 67e12/s), the
   card's nvidia-smi line, then the last line ``{"ok": true, "device":
   {...}}``.

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
#: the card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): device
#: memory bytes/s, and float32 operations/s outside the tensor cores (the
#: data sheet gives no int32 rate; the kernels' integer work is held to this)
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
#: the fragment edge batches' BAM header size (their refids reach past it)
N_EDGE_REFIDS = 3
#: chroms of the tree-level-boundary tables
BOUNDARY_CHROMS = 4
#: the count kernel's tallies in shared memory (csrc/count.cu kTallyChr,
#: kTallyRoi): chr slots and ROI rows past them are added in global memory,
#: which a wide header (GRCh38 with alts and decoys has thousands of
#: references) and a wide ROI table reach
SHARED_CHR, SHARED_ROI = 256, 64
WIDE_REFIDS, WIDE_ROIS = 300, 70
#: a whole-genome-sized map: ~144k introns over 24 chroms, like config C's
WHOLE_GENOME = dict(n_genes=18_000, n_chroms=24, chrom_len=130_000_000)
#: the whole-genome checkpoint phase: read pairs against WHOLE_GENOME (config
#: A's depth; config C's 25M pairs cut to a run's time), and the cadence
#: run's batches between snapshots
WG_PAIRS = 500_000
WG_EVERY = 4
#: the whole-genome cohort: COHORT_SAMPLES BAMs of COHORT_PAIRS pairs
#: (seeds COHORT_SEED + i) against WHOLE_GENOME through run_multi_bam: the
#: map at full width, the reads cut to the script's time (the counters'
#: size depends on the map alone)
COHORT_SAMPLES = 24
COHORT_PAIRS = 20_000
COHORT_SEED = 100
#: the genome shards of the padded-table kernel checks and of the
#: whole-genome mesh run
MESH_GENOME = 4
#: phase 7d's Mapability chromosome: MAP_LEN bases named like config A's,
#: a MAP_DUP_LEN-base duplicate (copies at MAP_DUP) and a MAP_N_LEN-base run
#: of Ns at MAP_N, all inside config A's gene bodies (so BuildRef --exclude
#: shrinks its measured bases); a whole genome is ~1,500x MAP_LEN
MAP_LEN = 2_000_000
MAP_DUP, MAP_DUP_LEN = (316_000, 1_235_000), 5_000
MAP_N, MAP_N_LEN = 718_000, 2_000
#: the IR-table line phase 7d changes for Goldens' mismatch
GOLDEN_LINE = 100
#: the synthetic long-intron run table: introns from 1 to LONG_MAX bases
LONG_INTRONS = 300
LONG_MAX = 300_000
#: phase 7e's long-read workload (bench/longread_throughput.py's): ONT/PacBio
#: reads of 16, 48 or 96 exon blocks over 10-100 kb against config A's map,
#: counted in both batch geometries
LONG_READS = 300_000
LONG_SEED = 5
LONG_WARM_RUNS = 2
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


def edge_batch(cols: dict, B: int, rng, n_refids: int = N_EDGE_REFIDS) -> dict:
    """A batch of B block lanes and B // 3 fragment lanes against the
    DeviceRef columns ``cols`` (ops/device_ref.py COLUMNS).  Blocks: pad
    lanes, chrom -1, chrom ids past the table (up to PAD_CHROM - 1), blocks
    shorter than 2*OH, both strands, blocks whose end-OH falls before the
    chrom's first point or below 0, blocks at span and point edges, int32
    wrap-around past INT32_MAX, hot-spot duplicates.  Fragments: refids over
    the header's n_refids, past it and -1, fragments on, beside and across
    each ROI, strands 0, 1 and others, pad rows."""
    from irfinder_tpu_torch.ops.device_ref import PAD_CHROM
    from irfinder_tpu_torch.ops.step import OVERHANG as OH

    i32 = np.int32
    uc, us, ul = (np.asarray(cols[k][:-1], np.int64) for k in ("uspan_chrom", "uspan_start", "uspan_len"))
    pc, pv = (np.asarray(cols[k][:-1], np.int64) for k in ("point_chrom", "point_coord"))
    n_chroms = len(cols["chrom_base"])
    top = int(max((us + ul).max(initial=0), pv.max(initial=0))) + 1000
    c = rng.integers(-1, n_chroms + 1, B)
    s = rng.integers(0, top, B)
    e = s + rng.integers(0, 3 * OH, B)  # many < 2*OH
    st = rng.integers(0, 2, B)
    q = B // 10
    c[:q], s[:q], e[:q] = rng.integers(0, n_chroms, q), 0, rng.integers(2 * OH, 4 * OH, q)
    c[q : 2 * q] = rng.integers(0, n_chroms, q)  # end - OH < 0
    s[q : 2 * q], e[q : 2 * q] = rng.integers(-300, -2 * OH, q), rng.integers(0, OH, q)
    if us.size:
        k = rng.integers(0, us.size, q)
        c[2 * q : 3 * q], s[2 * q : 3 * q], e[2 * q : 3 * q] = uc[k], us[k], us[k] + ul[k]
        k = rng.integers(0, us.size, q)  # across two spans
        c[3 * q : 4 * q], s[3 * q : 4 * q] = uc[k], us[k] + ul[k] // 2
        e[3 * q : 4 * q] = s[3 * q : 4 * q] + rng.integers(0, 5000, q)
    if pv.size:
        k = rng.integers(0, pv.size, q)
        c[4 * q : 5 * q], s[4 * q : 5 * q], e[4 * q : 5 * q] = pc[k], pv[k] - OH, pv[k] + OH
        e[4 * q : 5 * q] += rng.integers(-1, 2, q)
    c[5 * q : 6 * q], s[5 * q : 6 * q], e[5 * q : 6 * q] = 0, 5000, 5300  # hot spot
    c[6 * q : 7 * q] = -1  # explicit pad lanes
    c[7 * q : 7 * q + 50] = PAD_CHROM - 1  # the largest id a batch may carry
    c[7 * q + 50 : 7 * q + 100] = n_chroms + 1000
    w = slice(7 * q + 100, 7 * q + 200)  # start + OH and end - OH wrap
    c[w] = rng.integers(0, n_chroms, 100)
    s[w], e[w] = 2**31 - 1 - rng.integers(0, OH, 100), -(2**31) + rng.integers(0, 30, 100)

    F = B // 3
    fc = rng.integers(-1, n_chroms + 1, F)
    rid = rng.integers(-1, n_refids + 3, F)
    fs = rng.integers(0, top, F)
    fe = fs + rng.integers(0, 600, F)
    fst = rng.choice(np.array([0, 1, 0, 1, 2, -1]), F)
    rc, rs, re_ = (np.asarray(cols[k][:-1], np.int64) for k in ("roi_chrom", "roi_start", "roi_end"))
    per = F // (2 * max(1, rc.size))
    for r in range(rc.size):
        o = slice(r * per, (r + 1) * per)
        fc[o] = rc[r]
        fs[o] = rng.integers(rs[r] - 600, re_[r] + 10, per)
        fe[o] = fs[o] + rng.integers(0, 600, per)
        fs[o][:8], fe[o][:8] = re_[r], re_[r] + 100  # starts at the ROI's end: outside
        fs[o][8:16], fe[o][8:16] = rs[r] - 100, rs[r]  # ends at its start: outside
        fs[o][16:24], fe[o][16:24] = rs[r] - 100, rs[r] + 1  # one base inside
    pad = slice(F - F // 8, F)
    fc[pad], rid[pad], fs[pad], fe[pad], fst[pad] = -1, -1, 0, 0, 0
    return {
        "blk_chrom": c.astype(i32), "blk_start": s.astype(i32), "blk_end": e.astype(i32),
        "blk_strand": st.astype(i32),
        "frag_chrom": fc.astype(i32), "frag_refid": rid.astype(i32), "frag_start": fs.astype(i32),
        "frag_end": fe.astype(i32), "frag_strand": fst.astype(i32),
    }


def boundary_columns(n_span: int, n_point: int, rng, n_roi: int = 2) -> dict:
    """DeviceRef columns whose span and point key tables hold n_span and
    n_point keys (sentinel row included): disjoint spans and sorted points
    with duplicates over BOUNDARY_CHROMS chroms, one of them empty, and
    n_roi ROIs, some overlapping."""
    from irfinder_tpu_torch.ops.device_ref import PAD_CHROM

    n_c = BOUNDARY_CHROMS
    uc = np.sort(rng.choice(np.array([0, 2, 3]), n_span - 1))  # chrom 1 has no span
    us, ul = np.zeros(n_span - 1, np.int64), rng.integers(1, 300, n_span - 1)
    for ch in range(n_c):
        m = uc == ch
        gaps = rng.integers(1, 500, int(m.sum()))
        us[m] = np.cumsum(gaps) + np.concatenate([[0], np.cumsum(ul[m])[:-1]]) + 100
    off = np.concatenate([[0], np.cumsum(ul)])
    seg = np.searchsorted(uc, np.arange(n_c + 1), side="left")
    pc = np.sort(rng.choice(np.array([0, 1, 3]), n_point - 1))  # chrom 2 has no point
    pv = np.zeros(n_point - 1, np.int64)
    for ch in range(n_c):
        m = pc == ch
        pv[m] = np.sort(rng.integers(50, 1000 + 400 * int(m.sum()), int(m.sum())))
    if pv.size > 3 and pc[1] == pc[0]:
        pv[1] = pv[0]  # a duplicate point

    rc = np.sort(rng.integers(0, n_c, n_roi))
    rs = rng.integers(0, 20_000, n_roi)
    re_ = rs + rng.integers(1, 4000, n_roi)

    def sent(a, first):
        return np.append(a, PAD_CHROM if first else 0).astype(np.int32)

    return {
        "uspan_chrom": sent(uc, True), "uspan_start": sent(us, False),
        "uspan_len": sent(ul, False), "uspan_off": off.astype(np.int32),
        "chrom_base": off[seg[:-1]].astype(np.int32),
        "point_chrom": sent(pc, True), "point_coord": sent(pv, False),
        "roi_chrom": sent(rc, True), "roi_start": sent(rs, False), "roi_end": sent(re_, False),
        "mbs_size_static": int(off[-1]),
    }


def on_card(arrays: dict, dev) -> dict:
    """The columns count_step reads, as int32 tensors on the card."""
    from irfinder_tpu_torch.kernels import BLOCK_COLUMNS, FRAG_COLUMNS

    return {k: torch.from_numpy(np.ascontiguousarray(arrays[k], np.int32)).to(dev)
            for k in BLOCK_COLUMNS + FRAG_COLUMNS}


def compare_count(what: str, dref, batches: list, n_refids: int) -> int:
    """kernels.count_step against count_step_plain over ``batches``, each
    batch added to the same counters, bit for bit on cnt and chr."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.ops.step import OVERHANG as OH
    from irfinder_tpu_torch.ops.step import CounterLayout, count_step_plain, init_counters

    lay = CounterLayout.build(dref)
    got, want = init_counters(dref, n_refids), init_counters(dref, n_refids)
    before = kernels.launches["count_step"]
    for b in batches:
        kernels.count_step(dref, got, b, lay, OH)
        count_step_plain(dref, want, b, lay, OH)
    torch.cuda.synchronize()
    if kernels.launches["count_step"] != before + len(batches):
        raise AssertionError(f"count_step launched {kernels.launches['count_step'] - before} times "
                             f"for {len(batches)} batches")
    err = max(int((got[k].to(torch.int64) - want[k].to(torch.int64)).abs().max().item()) for k in got)
    eq = all(torch.equal(got[k], want[k]) for k in got)
    touched = int(torch.count_nonzero(want["cnt"]).item())
    print(f"kernels: count_step vs count_step_plain on {what}: {len(batches)} batch(es), "
          f"span levels {dref.uspan_levels}, point levels {dref.point_levels}, "
          f"max_abs_err={err} nonzero_cnt={touched} chr={want['chr'].tolist()[:8]} equal={eq}")
    if not eq or touched == 0 or int(want["chr"].sum()) == 0:
        raise AssertionError(f"count_step disagrees with count_step_plain on {what}")
    return err


def check_count_kernel(ref, dev) -> dict:
    """count_step vs count_step_plain on the card, bit for bit: synthetic and
    edge batches on config A's map, tables on every tree-level boundary, a
    whole-genome-sized map; then the old synthetic-repeat timing."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.conformance import synth_batch_arrays, synth_ref
    from irfinder_tpu_torch.ops.device_ref import build_device_ref, from_columns, ref_columns
    from irfinder_tpu_torch.ops.step import OVERHANG as OH
    from irfinder_tpu_torch.ops.step import CounterLayout, count_step_plain, init_counters
    from irfinder_tpu_torch.parallel.genome import plan_shards, shard_columns

    rng = np.random.default_rng(SEED)
    dref = build_device_ref(ref, dev)
    synth = [on_card(synth_batch_arrays(ref, n_frags=CAP_FRAGS, seed=s)[0], dev) for s in (1, 2)]
    B = synth[0]["blk_chrom"].shape[0]
    worst = compare_count(f"config A synth batches (B={B})", dref, synth, len(ref.chroms))
    edge = on_card(edge_batch(ref_columns(ref), B, rng), dev)
    worst = max(worst, compare_count("config A edge batch", dref, [edge], N_EDGE_REFIDS))

    sizes = [16**k + d for k in (1, 2, 3, 4) for d in (-1, 0, 1)]
    for i, n_span in enumerate(sizes):
        n_point = sizes[(i + 4) % len(sizes)]
        cols = boundary_columns(n_span, n_point, rng)
        b = on_card(edge_batch(cols, 3 * 8192, rng), dev)
        bref = from_columns(cols, dev)
        worst = max(worst, compare_count(f"a {n_span}-span {n_point}-point table", bref, [b], N_EDGE_REFIDS))

    # chr slots and ROI rows past the shared tallies: the kernel adds them in
    # global memory; the plain counters must hold some there, on both strands
    cols = boundary_columns(16**2 + 1, 16**3, rng, n_roi=WIDE_ROIS)
    b = on_card(edge_batch(cols, 3 * 8192, rng, n_refids=WIDE_REFIDS), dev)
    wide = from_columns(cols, dev)
    worst = max(worst, compare_count(f"a {WIDE_REFIDS}-refid header and {WIDE_ROIS} ROI rows", wide,
                                     [b], WIDE_REFIDS))
    wl = CounterLayout.build(wide)
    want = init_counters(wide, WIDE_REFIDS)
    count_step_plain(wide, want, b, wl, OH)
    past = [int(want["chr"][SHARED_CHR:].sum())] + [
        int(want["cnt"][wl.off_roi + s * (wl.R + 1) + SHARED_ROI : wl.off_roi + s * (wl.R + 1) + wl.R].sum())
        for s in (0, 1)]
    print(f"kernels: past the shared tallies: {past[0]} fragments in chr slots >= {SHARED_CHR} "
          f"(the trash slot {WIDE_REFIDS} included), {past[1]} / {past[2]} ROI overlaps in rows >= "
          f"{SHARED_ROI} (strand 0 / 1)")
    if min(past) == 0:
        raise AssertionError(f"the wide case reaches no global tally: {past}")

    t0 = time.perf_counter()
    wref = synth_ref(**WHOLE_GENOME)
    wd = build_device_ref(wref, dev)
    print(f"kernels: whole-genome-sized map {WHOLE_GENOME}: {wref.n_chroms} chroms, {wref.n_introns} "
          f"introns, {wref.uspan_start.size} spans, {wref.point_coord.size} points, {wref.mbs_size} MBS "
          f"bases, {4 * CounterLayout.build(wd).total} counter bytes, built in "
          f"{time.perf_counter() - t0:.3f} s")
    wb = [on_card(synth_batch_arrays(wref, n_frags=CAP_FRAGS, seed=s)[0], dev) for s in (1, 2)]
    worst = max(worst, compare_count("the whole-genome-sized map, 2 synth batches", wd, wb, wref.n_chroms))
    worst = max(worst, compare_count("the whole-genome-sized map, edge batch", wd,
                                     [on_card(edge_batch(ref_columns(wref), B, rng), dev)], N_EDGE_REFIDS))
    # the mesh's padded genome-shard tables (parallel/genome.py): sentinel
    # rows past the real ones, zero-width segments and chrom_base entries of
    # the chroms a shard does not own, a trash rank below the padded mbs;
    # config A's map at genome=4 leaves three shards empty
    for name, r, rb in (("the whole-genome-sized map", wref, wb), ("config A's map", ref, synth)):
        plan = plan_shards(r, MESH_GENOME)
        for i, cols in enumerate(shard_columns(r, plan)):
            sd = from_columns(cols, dev)
            worst = max(worst, compare_count(
                f"{name}'s padded genome shard {i} of {MESH_GENOME} (real mbs {plan.real[i]['mbs']} of "
                f"{plan.pads['mbs']})", sd, rb + [on_card(edge_batch(ref_columns(r), B, rng), dev)], N_EDGE_REFIDS))
            del sd
    del wd, wb
    torch.cuda.empty_cache()

    # the old figure, for continuity: one synthetic batch repeated (its
    # counter words stay in L2), counters accumulating
    lay = CounterLayout.build(dref)
    scratch = init_counters(dref, len(ref.chroms))
    b = synth[0]

    def kern():
        kernels.count_step(dref, scratch, b, lay, OH)

    def plain():
        count_step_plain(dref, scratch, b, lay, OH)

    plain_ms = time_ms(plain, 20)
    ms = time_ms(kern, 50)
    ms2 = time_ms(kern, 50)
    plain_ms2 = time_ms(plain, 20)
    print(f"kernels: count_step, one synth batch repeated, ms/call by CUDA events kernel={ms:.6f},{ms2:.6f} "
          f"plain={plain_ms:.6f},{plain_ms2:.6f} (plain, kernel, kernel, plain); device ms/call by "
          f"torch.profiler kernel={device_ms(kern)} plain={device_ms(plain)}")
    return {"max_abs_err": worst, "wref": wref}


def count_bound(what: str, dref, real: list, n_refids: int) -> dict:
    """count_step's work over the batches ``real`` (on the card), batch by
    batch, printed and returned: the real and pad lanes, the share of block
    lanes whose pairs the kernel skips, and the bound per batch."""
    from irfinder_tpu_torch.ops.device_ref import make_key, mbs_rank
    from irfinder_tpu_torch.ops.step import OVERHANG as OH
    from irfinder_tpu_torch.ops.step import CounterLayout, count_step_plain, init_counters

    lay = CounterLayout.build(dref)
    lanes = pads = frags = frag_pads = dd_skip = sp_skip = full = changed = 0
    for b in real:
        frag_ok = b["frag_refid"] >= 0
        frags += int(frag_ok.sum())
        frag_pads += int((~frag_ok).sum())
        c, s, e = b["blk_chrom"], b["blk_start"], b["blk_end"]
        ok = c >= 0
        same = mbs_rank(dref, c, s) == mbs_rank(dref, c, e)
        q_lo, q_hi = make_key(c, s + OH), make_key(c, e - OH)
        plo = torch.searchsorted(dref.point_key, q_lo)
        phi = torch.searchsorted(dref.point_key, q_hi, right=True)
        us = torch.searchsorted(dref.uspan_key, make_key(c, s), right=True)
        ue = torch.searchsorted(dref.uspan_key, make_key(c, e), right=True)
        points = ok & (e - s >= 2 * OH)
        lanes += int(ok.sum())
        pads += int((~ok).sum())
        dd_skip += int((ok & same).sum())
        sp_skip += int((ok & (~points | (plo == phi))).sum())
        # a walk the kernel's two keys leave undecided searches in full
        full += int((ok & ((e < s) | (ue - us >= 2) | (points & ((q_hi < q_lo) | (phi - plo >= 2))))).sum())
        delta = init_counters(dref, n_refids)
        count_step_plain(dref, delta, b, lay, OH)
        changed += sum(int(torch.count_nonzero(v).item()) for v in delta.values())
        del delta
    n = len(real)
    # the bound per batch: the four columns of a real block lane and the five
    # of a real fragment row, only the marker column of a pad (blk_chrom < 0;
    # frag_refid < 0, which sends the row to the trash slot), the sorted key
    # tables and span records (not the trees' upper levels), chrom_base, the
    # ROI table, and each changed cnt/chr word read and written once; the
    # operations: ~log2(table) compares of ~4 operations per search, four
    # searches per real block lane, ~6 per ROI row per real fragment and one
    # per pad
    tables = sum(t.numel() * t.element_size() for t in (
        dref.uspan_key, dref.uspan_rec, dref.chrom_base, dref.point_key,
        dref.roi_chrom, dref.roi_start, dref.roi_end))
    blk_bytes = (16 * lanes + 4 * pads) / n
    frag_bytes = (20 * frags + 4 * frag_pads) / n
    nbytes = blk_bytes + frag_bytes + tables + 8 * changed / n
    steps = 2 * np.log2(dref.uspan_key.numel()) + 2 * np.log2(dref.point_key.numel())
    ops = (lanes * (4 * steps + 16) + pads + frags * (6 * lay.R + 8) + frag_pads) / n
    bd = bound(nbytes, ops)
    print(f"kernels: count_step on {what}'s {n} batches: {lanes} block lanes, {pads} pad lanes "
          f"({100 * pads / (lanes + pads):.2f}%), {frags} fragment rows, {frag_pads} pad rows "
          f"({100 * frag_pads / (frags + frag_pads):.2f}%); of the block lanes, the depth pair skipped on "
          f"{100 * dd_skip / lanes:.2f}% (lo == hi) and the spans pair on {100 * sp_skip / lanes:.2f}% "
          f"(shorter than 2*OH, or plo == phi); a third search on {100 * full / lanes:.3f}% (an end "
          f"rank two or more keys past the start's)")
    print(f"kernels: count_step bound per batch of {what}: {nbytes:.1f} bytes ({blk_bytes:.1f} block "
          f"columns, {frag_bytes:.1f} fragment columns, {tables} key/record/ROI tables, {changed / n:.1f} "
          f"changed counter words read and written), {ops:.0f} operations: {bd['bound_ms']:.6f} ms by "
          f"{bd['bound_by']}")
    return {"n": n, **bd}


def count_real_batches(ref, bam: str, dev) -> dict:
    """count_step vs count_step_plain over every decoded batch of config A,
    accumulated; the kernel and plain times over those batches in turn; the
    share of block lanes whose pairs the kernel skips; the bound."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.engine import open_decoder
    from irfinder_tpu_torch.ops.device_ref import build_device_ref
    from irfinder_tpu_torch.ops.step import OVERHANG as OH
    from irfinder_tpu_torch.ops.step import CounterLayout, count_step_plain, init_counters

    header, batches, _ = open_decoder(ref, bam, CAP_FRAGS)
    n_refids = len(header.ref_names)
    real = [on_card(b.device_arrays(), dev) for b in batches]
    dref = build_device_ref(ref, dev)
    lay = CounterLayout.build(dref)
    worst = compare_count(f"all {len(real)} decoded batches of config A", dref, real, n_refids)
    w = count_bound("config A", dref, real, n_refids)
    n = w["n"]

    scratch = init_counters(dref, n_refids)

    def kern():
        for b in real:
            kernels.count_step(dref, scratch, b, lay, OH)

    def plain():
        for b in real:
            count_step_plain(dref, scratch, b, lay, OH)

    ev = [time_ms(kern, 10) / n, time_ms(kern, 10) / n]
    k_dev, p_dev = device_ms(kern, 5), device_ms(plain, 5)
    k_dev = float(k_dev) / n
    p_dev = float(p_dev) / n
    print(f"kernels: count_step over the {n} batches in turn, ms per batch: kernel {k_dev:.6f} device "
          f"(torch.profiler), {ev[0]:.6f},{ev[1]:.6f} by CUDA events (host launches included); plain "
          f"{p_dev:.6f} device")
    return {"max_abs_err": worst, "turn_ms": k_dev, "plain_ms": p_dev,
            "bound_ms": w["bound_ms"], "bound_by": w["bound_by"]}


def expect_launches(what: str, count_step: int, intron_stats: int = 1) -> dict:
    """The launches since the last reset_launches(), which must be exactly
    these."""
    from irfinder_tpu_torch import kernels

    got = dict(kernels.launches)
    if got != {"count_step": count_step, "intron_stats": intron_stats}:
        raise AssertionError(f"{what}: launches {got}, not count_step={count_step} "
                             f"intron_stats={intron_stats}")
    return got


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


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def device_ms(fn, reps: int = 20) -> str:
    """Summed device time of every kernel and copy ``fn`` runs, per call, from
    a torch.profiler trace (launch overhead on the host excluded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def compare_stats(what: str, finref, depth, flip: bool, cap: int, chunk: int) -> int:
    """One launch of intron_stats against all_stats_plain, bit for bit."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.ops import finalize_stats as FS

    before = kernels.launches["intron_stats"]
    got = FS.launch_all_stats_multi(finref, [depth], [FS.subset_planes(flip)["A"]], cap, chunk)[0]
    want = FS.all_stats_plain(depth, finref, FS.subset_planes(flip)["A"], cap)
    torch.cuda.synchronize()
    if kernels.launches["intron_stats"] != before + 1:
        raise AssertionError(f"intron_stats launched {kernels.launches['intron_stats'] - before} times")
    err = int((got - want).abs().max().item()) if got.numel() else 0
    eq = torch.equal(got, want)
    items = finref.items(chunk)
    print(f"kernels: intron_stats vs all_stats_plain on {what} flip={flip} cap={cap} chunk={chunk} "
          f"items={items.n_items} split_introns={items.n_split} rows={got.shape[0]} "
          f"max_abs_err={err} equal={eq}")
    if not eq:
        raise AssertionError(f"intron_stats disagrees with all_stats_plain on {what}")
    return err


def compare_stats_multi(what: str, finref, depths: list, plane_as: list, cap: int, chunk: int) -> int:
    """One N-sample launch of intron_stats against N single launches and
    against all_stats_multi_plain, bit for bit."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.ops import finalize_stats as FS

    before = kernels.launches["intron_stats"]
    got = FS.launch_all_stats_multi(finref, depths, plane_as, cap, chunk)
    torch.cuda.synchronize()
    if kernels.launches["intron_stats"] != before + 1:
        raise AssertionError(f"{len(depths)} samples took {kernels.launches['intron_stats'] - before} launches")
    singles = torch.stack([FS.launch_all_stats_multi(finref, [d], [a], cap, chunk)[0]
                           for d, a in zip(depths, plane_as)])
    want = FS.all_stats_multi_plain(depths, finref, plane_as, cap)
    torch.cuda.synchronize()
    err = int((got - want).abs().max().item()) if got.numel() else 0
    eq = torch.equal(got, want) and torch.equal(got, singles)
    items = finref.items(chunk)
    print(f"kernels: intron_stats over N={len(depths)} samples in one launch vs N single launches and "
          f"all_stats_multi_plain on {what} plane_as={plane_as} cap={cap} chunk={chunk} "
          f"work_items={len(depths) * items.n_items} split_introns={items.n_split} max_abs_err={err} equal={eq}")
    if not eq:
        raise AssertionError(f"the {len(depths)}-sample intron_stats launch disagrees on {what}")
    return err


def stats_bytes(finref, mbs: int) -> tuple:
    """The bytes intron_stats must move for one sample: both planes' words
    at every included base read once (a base that several introns include
    counts once), the run and item tables, the rows written.  Returns
    (bytes, included bases, table bytes, row bytes)."""
    from irfinder_tpu_torch.ops import finalize_stats as FS

    cover = np.zeros(mbs + 1, np.int64)
    st = finref.runs_host[1]
    np.add.at(cover, st, 1)
    np.add.at(cover, st + finref.runs_host[2], -1)
    unique = int((np.cumsum(cover)[:-1] > 0).sum())
    tables = 8 * st.size + 64 * finref.items(FS.CHUNK).n_items
    rows = 56 * finref.n_rows
    return 8 * unique + tables + rows, unique, tables, rows


def long_intron_table(rng):
    """A synthetic run table: LONG_INTRONS introns of 1 to LONG_MAX included
    bases (log-spaced), each in 1-4 runs with gaps between them, some
    overlapping the intron before; strands 0, 1 and 2."""
    from types import SimpleNamespace

    n = np.unique(np.geomspace(1, LONG_MAX, LONG_INTRONS).astype(np.int64))
    run_start, run_len, run_off = [], [], [0]
    pos = 0
    for nb in n:
        k = int(min(nb, rng.integers(1, 5)))
        cuts = np.sort(rng.choice(np.arange(1, nb), k - 1, replace=False)) if k > 1 else []
        lens = np.diff(np.concatenate([[0], cuts, [nb]])).astype(np.int64)
        p = pos - int(rng.integers(0, min(pos, 500) + 1))  # may overlap the last intron
        for ln in lens:
            run_start.append(p)
            run_len.append(ln)
            p += ln + int(rng.integers(0, 50))
        pos = max(pos, p)
        run_off.append(len(run_len))
    return SimpleNamespace(
        n_introns=n.size, mbs_size=pos,
        intron_run_off=np.array(run_off, np.int32),
        run_mbs_start=np.array(run_start, np.int64),
        run_len=np.array(run_len, np.int32),
        intron_strand=rng.integers(0, 3, n.size).astype(np.int8),
    )


def blocky_depth(rng, mbs: int) -> np.ndarray:
    """A piecewise-constant (2, mbs) depth, as coverage is: blocks of 1-300
    bases, zero-heavy, with a hot stretch above the 2,048-bin cap."""
    out = np.zeros((2, mbs), np.int32)
    for k in (0, 1):
        cuts = np.sort(rng.choice(np.arange(1, mbs), mbs // 100, replace=False))
        vals = rng.integers(0, 40, cuts.size + 1).astype(np.int32)
        vals[rng.random(cuts.size + 1) < 0.3] = 0
        out[k] = np.repeat(vals, np.diff(np.concatenate([[0], cuts, [mbs]])))
    out[:, mbs // 3 : mbs // 3 + 5000] += HOT
    return out


def check_stats_kernel(ref, real_depth, dev) -> dict:
    """intron_stats vs all_stats_plain on the card, bit for bit; the whole
    device statistics against the CPU plain path and the host path."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.conformance import depth_stats_host
    from irfinder_tpu_torch.ops import finalize_stats as FS
    from irfinder_tpu_torch.ops.step import depth_on_device

    finref = FS.build_finalize_ref(ref, dev)
    print("kernels: intron_stats subsets " + " ".join(
        f"{k}: {finref.subsets[k].size} introns {int(finref.subsets[k].n_bases.sum())} bases"
        for k in FS.SUBSET_ORDER))
    rng = np.random.default_rng(SEED + 1)
    rand = rng.integers(0, 7, size=(2, ref.mbs_size)).astype(np.int32)
    rand[rng.random((2, ref.mbs_size)) < 0.3] = 0  # coverage gaps
    hot = rand.copy()
    hot[:, : ref.mbs_size // 2] += HOT
    cases = {"real": real_depth, "random": depth_on_device(rand, dev), "hot": depth_on_device(hot, dev)}
    worst = 0
    for name, depth in cases.items():
        for flip in (False, True):
            for cap in (FS.CAP, 4):
                worst = max(worst, compare_stats(f"{name} depth", finref, depth, flip, cap, FS.CHUNK))
    if finref.items(FS.CHUNK).n_split:
        raise AssertionError("an intron of config A split at the default chunk")

    # the histogram's limit: the largest cap launches and agrees, one more raises
    mx = kernels.intron_stats_max_cap()
    worst = max(worst, compare_stats("hot depth", finref, cases["hot"], False, mx, FS.CHUNK))
    try:
        FS.launch_all_stats_multi(finref, [cases["hot"]], [0], mx + 1)
    except ValueError:
        pass
    else:
        raise AssertionError(f"intron_stats took cap={mx + 1}, past its shared-memory limit")
    print(f"kernels: intron_stats at its largest cap={mx} equal to plain on the hot depth; "
          f"cap={mx + 1} refused")

    # forced splits: chunk 1 splits every intron of two or more bases
    n_multi = int((finref.n_bases > 1).sum())
    for name, flip, cap, chunk in (("real depth", False, FS.CAP, 1), ("hot depth", True, FS.CAP, 1),
                                   ("hot depth", False, 4, 777), ("real depth", True, FS.CAP, 97)):
        worst = max(worst, compare_stats(name, finref, cases[name.split()[0]], flip, cap, chunk))
    if finref.items(1).n_split != n_multi:
        raise AssertionError(f"chunk 1 split {finref.items(1).n_split} introns, not {n_multi}")

    # the long-intron run table
    lref = long_intron_table(np.random.default_rng(SEED + 2))
    lfin = FS.build_finalize_ref(lref, dev)
    ld = depth_on_device(blocky_depth(np.random.default_rng(SEED + 3), lref.mbs_size), dev)
    print(f"kernels: long-intron table: {lref.n_introns} introns of {int(lfin.n_bases.min())} to "
          f"{int(lfin.n_bases.max())} bases, {lref.run_len.size} runs, {lref.mbs_size} MBS bases")
    for flip in (False, True):
        for cap, chunk in ((FS.CAP, FS.CHUNK), (FS.CAP, 4096), (4, 1000)):
            worst = max(worst, compare_stats("long-intron table", lfin, ld, flip, cap, chunk))
    if lfin.items(FS.CHUNK).n_split == 0:
        raise AssertionError("no intron of the long-intron table split at the default chunk")

    # one launch over several samples: mixed polarity, forced splits, the
    # long-intron table's split path, and N = 1
    trio = [cases["real"], cases["random"], cases["hot"]]
    for plane_as in ([0, 1, 1], [1, 0, 0]):
        worst = max(worst, compare_stats_multi("the real, random and hot depths", finref, trio, plane_as,
                                               FS.CAP, FS.CHUNK))
    for chunk in (1, 97):
        worst = max(worst, compare_stats_multi("the real, random and hot depths", finref, trio, [1, 0, 1],
                                               FS.CAP, chunk))
    worst = max(worst, compare_stats_multi("the hot, real and random depths", finref, trio[::-1], [0, 0, 1],
                                           4, 777))
    lds = [ld] + [depth_on_device(blocky_depth(np.random.default_rng(SEED + 4 + i), lref.mbs_size), dev)
                  for i in range(2)]
    for chunk in (FS.CHUNK, 4096):
        worst = max(worst, compare_stats_multi("three long-intron-table depths", lfin, lds, [1, 0, 1],
                                               FS.CAP, chunk))
    worst = max(worst, compare_stats_multi("the real depth", finref, trio[:1], [1], FS.CAP, FS.CHUNK))
    del ld, lds

    cpu_fr = FS.build_finalize_ref(ref, "cpu")
    for name, cap in (("hot", FS.CAP), ("random", 4)):
        d_np = cases[name].cpu().numpy()
        for flip in (False, True):
            info = {}
            plane_a = FS.subset_planes(flip)["A"]
            got = FS.device_all_stats_multi_async(ref, finref, [cases[name]], [plane_a], cap=cap, info=info)()[0]
            want = FS.device_all_stats_multi_async(ref, cpu_fr, [cases[name].cpu()], [plane_a], cap=cap)()[0]
            for v, introns in own_introns(ref, flip).items():
                host = depth_stats_host(ref, (d_np[0] + d_np[1] if v == 2 else d_np[v]).astype(np.int64))
                for g, w, h in zip(got[v], want[v], host):
                    if not np.array_equal(g, w) or not np.array_equal(g[introns], h[introns]):
                        raise AssertionError(f"device statistics differ on {name} flip={flip} variant {v}")
            print(f"kernels: device_all_stats_multi_async on {name} depth flip={flip} cap={cap}: saturated "
                  f"introns taking the exact fallback={info['saturated']}; equal to the CPU plain "
                  f"path and to the host path on every variant")
            if info["saturated"] == 0:
                raise AssertionError(f"the saturated fallback did not run on {name}")

    depth = cases["real"]

    def kern():
        FS.launch_all_stats_multi(finref, [depth], [0])

    def plain():
        FS.all_stats_plain(depth, finref, 0, FS.CAP)

    plain_ms = time_ms(plain, 10)
    ms = time_ms(kern, 50)
    ms2 = time_ms(kern, 50)
    plain_ms2 = time_ms(plain, 10)
    print(f"kernels: intron_stats, one launch for 3 subsets on the real depth, ms per finalize by "
          f"CUDA events kernel={ms:.6f},{ms2:.6f} plain={plain_ms:.6f},{plain_ms2:.6f} "
          f"(plain, kernel, kernel, plain)")
    print(f"kernels: intron_stats, device ms per finalize by torch.profiler "
          f"kernel={device_ms(kern)} plain={device_ms(plain)}")
    # the bound: stats_bytes; ~12 integer operations per base of each intron
    nbytes, unique, tables, rows = stats_bytes(finref, ref.mbs_size)
    b = bound(nbytes, 12 * int(finref.n_bases.sum()))
    print(f"kernels: intron_stats bound: {nbytes} bytes ({unique} included bases x 2 planes x 4 B, "
          f"{tables} table bytes, {rows} row bytes): {b['bound_ms']:.6f} ms by {b['bound_by']} "
          f"(3.35 TB/s); kernel at {100 * b['bound_ms'] / min(ms, ms2):.1f}% of it by CUDA events")
    return {"max_abs_err": worst, "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2), **b}


def check_oracle_tables(ref, bam: str, out: str, long_reads: bool = False) -> None:
    """The IR, SpansPoint, ROI and ChrCoverage tables in ``out`` against the
    ones rendered from native/oracle's counters for ``bam``, decoded in the
    long-read batch geometry with ``long_reads``."""
    from irfinder_tpu_torch.conformance import oracle_run, oracle_tables

    ofc, header, _, _ = oracle_run(ref, bam, CAP_FRAGS, long_reads=long_reads)
    for name, text in oracle_tables(ref, header, ofc).items():
        with open(os.path.join(out, name)) as fh:
            if fh.read() != text:
                raise AssertionError(f"{out}: {name} differs from the oracle's")


def read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def batch_phase(ref, bam0: str, tmp: str, dev) -> dict:
    """Config D: run_multi_bam over N_SAMPLES BAMs on the card, checked per
    sample against a solo run and the oracle, then timed warm.  Returns the
    BAMs, the output directories and the first run's wall."""
    from irfinder_tpu_torch import engine as E
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.conformance import write_realistic_bam
    from irfinder_tpu_torch.engine import run_bam, run_multi_bam

    budget = E.MULTI_STATS_BUDGET
    if 2 * N_SAMPLES * ref.mbs_size * 4 > budget:
        raise AssertionError("config D's depth rows pass MULTI_STATS_BUDGET: it would not batch")
    serial = [os.path.join(tmp, "batch_serial", f"s{i}") for i in range(N_SAMPLES)]
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
    if launched["count_step"] != batches or launched["intron_stats"] != 1:
        raise AssertionError(f"batch launches {launched} for {batches} batches: the {N_SAMPLES} samples' "
                             f"statistics must take one intron_stats launch")
    for i, bam in enumerate(bams):
        solo = os.path.join(tmp, "solo", f"s{i}")
        run_bam(ref, bam, solo, cap_frags=CAP_FRAGS, device=dev)
        for name in TABLES:
            if read(os.path.join(outs[i], name)) != read(os.path.join(solo, name)):
                raise AssertionError(f"sample {i}: {name} differs between batch and solo")
        check_oracle_tables(ref, bam, outs[i])
    print(f"batch: every sample's {len(TABLES)} tables byte-identical to its solo run, and its "
          f"IR-nondir IR-dir SpansPoint ROI ChrCoverage to the oracle's")
    stats_d = config_d_stats(ref, bams, dev)

    # warm runs of the batched finalize, in turns with the one-sample-at-a-time
    # path (MULTI_STATS_BUDGET 0), whose tables must be the same
    walls, per_sample = [], []
    for r, batched in enumerate([True, False] * (BATCH_WARM_RUNS - 1) + [True]):
        E.MULTI_STATS_BUDGET = budget if batched else 0
        kernels.reset_launches()
        t0 = time.perf_counter()
        ms = run_multi_bam(ref, bams, outs if batched else serial, cap_frags=CAP_FRAGS, device=dev)
        (walls if batched else per_sample).append(time.perf_counter() - t0)
        print(f"batch: warm run {r} ({'batched' if batched else 'one sample at a time'}): "
              f"wall={(walls if batched else per_sample)[-1]:.6f} s "
              f"aggregate reads/s={reads / (walls if batched else per_sample)[-1]:.1f} "
              f"multi_stream_s={ms[0].multi_stream_s:.6f} multi_finalize_s={ms[0].multi_finalize_s:.6f} "
              f"decode_s(sum)={sum(m.decode_s for m in ms):.6f} "
              f"intron_stats launches={kernels.launches['intron_stats']}")
    E.MULTI_STATS_BUDGET = budget
    for i in range(N_SAMPLES):
        same_tables(serial[i], outs[i])
    med = float(np.median(walls))
    print(f"batch: {BATCH_WARM_RUNS} warm batched runs: median wall={med:.6f} s "
          f"aggregate reads/s={reads / med:.1f}; one sample at a time: walls "
          f"{','.join(f'{w:.6f}' for w in per_sample)} s, every table byte-identical to the batched run's")
    return {"bams": bams, "outs": outs, "wall": wall, "launches": launched, "stats": stats_d}


def config_d_stats(ref, bams: list, dev) -> dict:
    """intron_stats over config D's N_SAMPLES depths (of mixed polarity) in
    one launch, held to N single launches bit for bit and timed against
    them, in turns (singles, one launch, one launch, singles)."""
    from irfinder_tpu_torch.ops import finalize_stats as FS

    finref = FS.build_finalize_ref(ref, dev)
    depths = [port_counters(ref, b, dev)["depth"] for b in bams]
    plane_as = [i % 2 for i in range(len(depths))]
    err = compare_stats_multi(f"config D's {len(depths)} depths", finref, depths, plane_as, FS.CAP, FS.CHUNK)

    def multi():
        FS.launch_all_stats_multi(finref, depths, plane_as)

    def singles():
        for d, a in zip(depths, plane_as):
            FS.launch_all_stats_multi(finref, [d], [a])

    s1, m1, m2, s2 = (time_ms(fn, 10) for fn in (singles, multi, multi, singles))
    dev_s, dev_m = device_ms(singles), device_ms(multi)
    nbytes = len(depths) * stats_bytes(finref, ref.mbs_size)[0]
    b = bound(nbytes, 12 * len(depths) * int(finref.n_bases.sum()))
    print(f"batch: intron_stats over config D's {len(depths)} samples, ms by CUDA events in turns (host "
          f"launches included): {len(depths)} single launches {s1:.6f},{s2:.6f}; one launch {m1:.6f},{m2:.6f}; "
          f"device ms by torch.profiler: singles={dev_s} one launch={dev_m}; bound {nbytes} bytes -> "
          f"{b['bound_ms']:.6f} ms by {b['bound_by']}")
    return {"n_samples": len(depths), "ms": min(m1, m2), "singles_ms": min(s1, s2), "device_ms": dev_m,
            "singles_device_ms": dev_s, "max_abs_err": err, **b}


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


def run_spans(phase: str, ref, bam: str, dev, long_reads: bool = False) -> None:
    """One run_bam (in the long-read batch geometry with ``long_reads``)
    and the seconds of its phases (RunMetrics.spans, spans.py), with the
    counters taken at their boundaries."""
    from irfinder_tpu_torch.config import RunConfig
    from irfinder_tpu_torch.engine import run_bam

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    m = run_bam(ref, bam, os.path.join(os.path.dirname(bam), f"{phase}_spans"),
                config=RunConfig(cap_frags=CAP_FRAGS, long_reads=long_reads), device=dev)
    wall = time.perf_counter() - t0
    print(f"{phase}: run_bam wall={wall:.6f} s spans s "
          + " ".join(f"{k}={v:.6f}" for k, v in m.spans.items())
          + f" (table_bytes={m.table_bytes} junctions_distinct={m.junctions_distinct} "
          f"stream_waits={m.stream_waits} batches={m.batches})")


def measure(ref, bam: str, dev) -> float:
    """Warm repeats of the main path, one more run's spans, the oracle
    again, and one run under torch.profiler: the card's busy share (device
    kernels and copies only, so nothing counts twice), the count kernel's
    launches and device time (returned: ms per launch), and the D2H sizes."""
    from torch.profiler import ProfilerActivity, profile

    from irfinder_tpu_torch.conformance import oracle_run
    from irfinder_tpu_torch.engine import run_bam

    walls = []
    for i in range(WARM_RUNS):
        t0 = time.perf_counter()
        m = run_bam(ref, bam, os.path.join(os.path.dirname(bam), f"warm{i}"),
                    cap_frags=CAP_FRAGS, device=dev)
        wall = time.perf_counter() - t0
        walls.append(wall)
        print(f"measure: warm run {i}: wall={wall:.6f} s reads/s={m.reads_total / wall:.1f} "
              f"decode_s={m.decode_s:.6f} stage={m.spans['stage']:.6f} count={m.spans['count']:.6f} "
              f"sync={m.spans['sync']:.6f} finalize_s={m.finalize_s:.6f}")
    q1, med, q3 = np.percentile(walls, [25, 50, 75])
    print(f"measure: {WARM_RUNS} warm runs: median wall={med:.6f} s "
          f"reads/s={m.reads_total / med:.1f} quartiles={q1:.6f}-{q3:.6f} s")
    run_spans("measure", ref, bam, dev)

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
    count = [(us, n) for us, n, k in items if "count_step_kernel" in k]
    if len(count) != 1 or count[0][1] != mp.batches:
        raise AssertionError(f"count kernel entries {count} in the profiled run of {mp.batches} batches")
    index_add = [e.key for e in prof.key_averages() if "index_add" in e.key or "indexFunc" in e.key]
    if index_add:
        raise AssertionError(f"the profiled run has index_add: {index_add}")
    per_launch = count[0][0] / 1e3 / count[0][1]
    print(f"measure: profiled run: count_step_kernel {count[0][1]} launches for {mp.batches} batches, "
          f"{per_launch:.6f} ms device per launch; no index_add")
    trace = os.path.join(os.path.dirname(bam), "trace.json")
    prof.export_chrome_trace(trace)
    d2h = d2h_copies(trace)
    print(f"measure: profiled run D2H copies={len(d2h)} bytes={sorted(d2h, reverse=True)}")
    if not d2h or max(d2h) >= D2H_LIMIT:
        raise AssertionError(f"a finalize D2H of {max(d2h, default=0)} bytes (limit {D2H_LIMIT})")
    return per_launch


def same_tables(a: str, b: str, names=TABLES) -> None:
    for name in names:
        if read(os.path.join(a, name)) != read(os.path.join(b, name)):
            raise AssertionError(f"{name} differs between {a} and {b}")


def run_cli(argv: list, rc: int = 0) -> tuple:
    """cli.main(argv), which must exit ``rc``.  Returns what it printed: the
    metrics JSON its output opens with (None if it opens with none), the
    rest of its standard output, and its standard error."""
    import contextlib
    import io

    from irfinder_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        got = cli.main(argv)
    if got != rc:
        raise AssertionError(f"cli {argv[0]} exited {got}, not {rc}: {out.getvalue()[-2000:]}"
                             f"{err.getvalue()[-2000:]}")
    text = out.getvalue()
    if not text.startswith("{"):
        return None, text, err.getvalue()
    metrics, end = json.JSONDecoder().raw_decode(text)
    return metrics, text[end:].strip(), err.getvalue()


def fastq_phase(ref, bam: str, out_a: str, tmp: str, dev) -> None:
    """FastQ mode on the card off a stand-in aligner that cats config A's
    BAM: spooled, --stream --keep-bam, and --trim; tables byte-identical to
    config A's run_bam (``out_a``), the tee to the input; the --stream wall
    against run_bam's in turns."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.engine import run_bam
    from irfinder_tpu_torch.native.trim_native import ADAPTER_R1

    ref_dir = os.path.join(tmp, "REF")
    ref.save(ref_dir)
    fake = os.path.join(tmp, "aligner.sh")
    with open(fake, "w") as fh:
        fh.write(f"#!/bin/sh\ncat {bam}\n")
    os.chmod(fake, 0o755)
    r1, r2 = os.path.join(tmp, "r_1.fq"), os.path.join(tmp, "r_2.fq")
    seq = "ACGTACGTAC" + ADAPTER_R1.decode()
    with open(r1, "w") as fh:
        fh.write(f"@a0\n{seq}\n+\n{'I' * len(seq)}\n@a1\nGGGGCCCCAAAATTTT\n+\n{'I' * 16}\n")
    with open(r2, "w") as fh:
        fh.write(f"@a0\nTTTTGGGGCC\n+\nIIIIIIIIII\n@a1\nCCCCAAAAGGGGTTTT\n+\n{'I' * 16}\n")
    base = ["-r", ref_dir, r1, r2, "--aligner-cmd", f"{fake} {{r1}} {{r2}}", "--device", dev.type]
    for mode, flags in (("spooled", []), ("stream", ["--stream", "--keep-bam"]), ("trim", ["--trim"])):
        out = os.path.join(tmp, f"fastq_{mode}")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        m, _, _ = run_cli(["FastQ", "-d", out, *base, *flags])
        wall = time.perf_counter() - t0
        launched = expect_launches(f"FastQ {mode}", m["batches"])
        same_tables(out, out_a)
        extra = ""
        if mode == "stream":
            if read(os.path.join(out, "Unsorted.bam")) != read(bam):
                raise AssertionError("the teed Unsorted.bam differs from the aligner's output")
            extra = ", the teed Unsorted.bam byte-identical to the input"
        if mode == "trim":
            with open(os.path.join(out, "trimmed_1.fastq")) as fh:
                kept = fh.read().splitlines()
            if kept[1] != "ACGTACGTAC" or kept[5] != "GGGGCCCCAAAATTTT":
                raise AssertionError(f"--trim kept {kept[1]!r} and {kept[5]!r}")
            extra = ", the adapter clipped (kept 10 of 43 bases) and the clean read whole"
        print(f"fastq: FastQ {' '.join(flags) or '(spooled)'} wall={wall:.6f} s reads={m['reads_total']} "
              f"batches={m['batches']} launches={launched}; {len(TABLES)} tables byte-identical to config "
              f"A's run_bam{extra}")
    walls = {"run_bam": [], "stream": []}
    for kind in ("run_bam", "stream", "stream", "run_bam"):
        out = os.path.join(tmp, f"turn_{kind}")
        t0 = time.perf_counter()
        if kind == "run_bam":
            run_bam(ref, bam, out, device=dev)
        else:
            run_cli(["FastQ", "-d", out, *base, "--stream"])
        walls[kind].append(time.perf_counter() - t0)
    print(f"fastq: in turns (run_bam, stream, stream, run_bam), wall s: FastQ --stream "
          f"{walls['stream'][0]:.6f},{walls['stream'][1]:.6f}; run_bam "
          f"{walls['run_bam'][0]:.6f},{walls['run_bam'][1]:.6f}")


def whole_genome_run(wref, tmp: str, dev) -> dict:
    """The whole-genome BAM written and counted by run_bam: the reference
    the checkpoint and mesh phases hold their runs to."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.conformance import write_realistic_bam
    from irfinder_tpu_torch.engine import run_bam

    wbam = os.path.join(tmp, "wholegenome.bam")
    t0 = time.perf_counter()
    n_rec = write_realistic_bam(wbam, wref, n_pairs=WG_PAIRS, seed=1).n_records
    print(f"checkpoint: whole-genome BAM of {n_rec} records against the {wref.n_chroms}-chrom map "
          f"written in {time.perf_counter() - t0:.3f} s")

    full = os.path.join(tmp, "wg_full")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = run_bam(wref, wbam, full, cap_frags=CAP_FRAGS, device=dev)
    wall = time.perf_counter() - t0
    launched = expect_launches("whole-genome run_bam", m.batches)
    whole = {"wbam": wbam, "full": full, "wall": wall, "m": m, "peak": torch.cuda.max_memory_allocated(dev)}
    print(f"checkpoint: whole-genome run_bam wall={wall:.6f} s reads={m.reads_total} "
          f"reads/s={m.reads_total / wall:.1f} batches={m.batches} decode_s={m.decode_s:.6f} "
          f"stage={m.spans['stage']:.6f} count={m.spans['count']:.6f} sync={m.spans['sync']:.6f} "
          f"finalize_s={m.finalize_s:.6f} blocks_inflated={m.blocks_inflated} launches={launched} "
          f"peak_mem_bytes={whole['peak']}")
    return whole


def checkpoint_phase(wref, whole: dict, tmp: str, dev) -> None:
    """The whole-genome run (``whole``, from whole_genome_run) against the
    oracle, then snapshot, interrupt and resume on the card (see the module
    docstring, phase 7b)."""
    import itertools

    from irfinder_tpu_torch import checkpoint as CK
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.conformance import oracle_run, oracle_tables
    from irfinder_tpu_torch.engine import Engine, open_decoder, run_bam
    from irfinder_tpu_torch.ops import finalize_stats as FS

    wbam, full, m = whole["wbam"], whole["full"], whole["m"]
    t0 = time.perf_counter()
    ofc, header, t_dec, t_orc = oracle_run(wref, wbam, CAP_FRAGS)
    pfc = port_counters(wref, wbam, dev)
    for k in ("depth", "span_hits", "roi_cnt", "chr_frag", "n_frags"):
        if not np.array_equal(np.asarray(ofc[k]).astype(np.int64), pfc[k].cpu().numpy().astype(np.int64)):
            raise AssertionError(f"whole genome: counter {k} differs from the oracle")
    for name, text in oracle_tables(wref, header, ofc).items():
        if read(os.path.join(full, name)) != text.encode():
            raise AssertionError(f"whole genome: {name} differs from the oracle's")
    print(f"checkpoint: whole genome: counters integer-identical to the oracle's and IR-nondir IR-dir "
          f"SpansPoint ROI ChrCoverage byte-identical (oracle decode {t_dec:.6f} s, count {t_orc:.6f} s; "
          f"checks {time.perf_counter() - t0:.3f} s)")
    del ofc
    finref = FS.build_finalize_ref(wref, dev)
    depth = pfc["depth"]
    err = compare_stats("the whole-genome depth", finref, depth, False, FS.CAP, FS.CHUNK)
    # CUDA events: a torch.profiler trace at this point, after the measure
    # phase's, reports no device time for this launch
    ms = time_ms(lambda: FS.launch_all_stats_multi(finref, [depth], [0]), 5)
    print(f"checkpoint: intron_stats on the whole-genome depth: {ms:.6f} ms per finalize by CUDA events "
          f"(max_abs_err={err})")
    del pfc, depth, finref
    torch.cuda.empty_cache()
    run_spans("checkpoint", wref, wbam, dev)
    torch.cuda.empty_cache()

    ck = os.path.join(tmp, "wg_state.npz")
    t0 = time.perf_counter()
    mc = run_bam(wref, wbam, os.path.join(tmp, "wg_cadence"), cap_frags=CAP_FRAGS, checkpoint=ck,
                 checkpoint_every=WG_EVERY, device=dev)
    print(f"checkpoint: run_bam under the cadence (a snapshot due every {WG_EVERY} batches, after 4x the "
          f"last one's seconds): wall={time.perf_counter() - t0:.6f} s snapshots={mc.checkpoints} "
          f"checkpoint_s={mc.checkpoint_s:.6f}")
    same_tables(os.path.join(tmp, "wg_cadence"), full)
    if os.path.exists(ck):
        raise AssertionError("the cadence run left its snapshot behind")

    half = m.batches // 2
    eng = Engine(wref, device=dev)
    header, batches, _ = open_decoder(wref, wbam, CAP_FRAGS)
    eng.reset(n_refids=len(header.ref_names))
    eng.run_stream(itertools.islice(batches, half))
    del batches
    st = eng._st
    cnt = st.counters["cnt"].cpu().numpy()
    seen = {}
    for pack in ("card", "host", "host", "card"):
        pull = CK.pull_card if pack == "card" else CK.pull_host
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = CK.save_checkpoint(ck, st, pull=pull)
        info["total_s"] = time.perf_counter() - t0
        seen.setdefault(pack, []).append(info)
        if not np.array_equal(CK.load_checkpoint(ck)[0][0], cnt):
            raise AssertionError(f"the {pack} pack's snapshot does not hold the counters")
        print(f"checkpoint: snapshot by the {pack} pack after {half} of {m.batches} batches: "
              f"{info['total_s']:.6f} s = pack {info['pack_s']:.6f} + D2H {info['d2h_s']:.6f} + write "
              f"{info['write_s']:.6f} (+ tally); {info['bytes']} file bytes for {cnt.nbytes} counter bytes, "
              f"{info['escapes']} escapes")
        torch.cuda.empty_cache()
    legacy = os.path.join(tmp, "wg_legacy.npz")
    token, st.resume_token = st.resume_token, None
    CK.save_checkpoint(legacy, st)
    st.resume_token = token
    del eng, st
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    snap = CK.load_checkpoint(ck)
    t1 = time.perf_counter()
    rs = CK.restore_state(Engine(wref, device=dev), snap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"checkpoint: load {t1 - t0:.6f} s, restore onto the card {t2 - t1:.6f} s "
          f"({rs.metrics.batches} batches done, token of {len(rs.resume_token)} bytes)")
    del rs, snap
    torch.cuda.empty_cache()

    for i, (name, path) in enumerate((("resumed", ck), ("resumed without a token", legacy))):
        out = os.path.join(tmp, f"wg_resumed{i}")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        mr = run_bam(wref, wbam, out, cap_frags=CAP_FRAGS, checkpoint=path, device=dev)
        wall = time.perf_counter() - t0
        launched = expect_launches(f"whole-genome run_bam {name}", m.batches - half)
        same_tables(out, full)
        if os.path.exists(path) or mr.batches != m.batches or mr.reads_total != m.reads_total:
            raise AssertionError(f"{name}: snapshot left behind or counts differ ({mr.batches} batches)")
        print(f"checkpoint: whole-genome run_bam {name}: wall={wall:.6f} s launches={launched} "
              f"(the {m.batches - half} batches after the snapshot) blocks_inflated={mr.blocks_inflated} "
              f"(full run: {m.blocks_inflated}) finalize_s={mr.finalize_s:.6f}; {len(TABLES)} tables "
              f"byte-identical to the uninterrupted run, snapshot removed")
    best = {k: min(i["total_s"] for i in v) for k, v in seen.items()}
    print(f"checkpoint: fastest snapshot: card pack {best['card']:.6f} s, host pack {best['host']:.6f} s")


def cohort_phase(wref, tmp: str, dev) -> dict:
    """Batch mode over a whole-genome cohort: COHORT_SAMPLES BAMs against the
    whole-genome map through run_multi_bam, whose depth rows pass
    MULTI_STATS_BUDGET, so the samples finalize one at a time.  Every
    sample's tables byte-identical to its solo run_bam; the peak device
    memory below the samples' counters and depth rows all at once.
    Returns the launches."""
    from irfinder_tpu_torch import engine as E
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.conformance import write_realistic_bam
    from irfinder_tpu_torch.ops.step import CounterLayout

    n = COHORT_SAMPLES
    if 2 * n * wref.mbs_size * 4 <= E.MULTI_STATS_BUDGET:
        raise AssertionError("the cohort's depth rows fit MULTI_STATS_BUDGET: it would batch")
    bams = [os.path.join(tmp, f"cohort_{i}.bam") for i in range(n)]
    t0 = time.perf_counter()
    n_rec = sum(write_realistic_bam(b, wref, n_pairs=COHORT_PAIRS, seed=COHORT_SEED + i).n_records
                for i, b in enumerate(bams))
    print(f"cohort: {n} whole-genome BAMs of {COHORT_PAIRS} pairs, {n_rec} records, written in "
          f"{time.perf_counter() - t0:.3f} s")
    cnt_bytes = CounterLayout.build(E.Engine(wref, device=dev).dref).total * 4
    rows_bytes = 2 * (-(-(wref.mbs_size + 1) // 8) * 8) * 4
    outs = [os.path.join(tmp, "cohort", f"s{i}") for i in range(n)]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    ms = E.run_multi_bam(wref, bams, outs, cap_frags=CAP_FRAGS, device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    batches = sum(m.batches for m in ms)
    launched = expect_launches("the whole-genome cohort's run_multi_bam", batches, n)
    limit = n * (cnt_bytes + rows_bytes)
    print(f"cohort: run_multi_bam over {n} samples against the {wref.n_chroms}-chrom map wall={wall:.6f} s "
          f"reads={sum(m.reads_total for m in ms)} batches={batches} multi_stream_s={ms[0].multi_stream_s:.6f} "
          f"multi_finalize_s={ms[0].multi_finalize_s:.6f} launches={launched} peak_mem_bytes={peak} "
          f"(counters {cnt_bytes} and padded depth rows {rows_bytes} bytes a sample: {n} x counters + one "
          f"sample's rows = {n * cnt_bytes + rows_bytes}; every sample's at once = {limit})")
    if peak >= limit:
        raise AssertionError(f"the cohort's peak {peak} bytes reaches {n} samples' counters and rows ({limit})")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for i, b in enumerate(bams):
        solo = os.path.join(tmp, "cohort_solo", f"s{i}")
        E.run_bam(wref, b, solo, cap_frags=CAP_FRAGS, device=dev)
        same_tables(outs[i], solo)
    print(f"cohort: every sample's {len(TABLES)} tables byte-identical to its solo run_bam "
          f"({n} solo runs in {time.perf_counter() - t0:.3f} s)")
    return {"launches": launched, "peak": peak, "wall": wall}


def mesh_cells(spec) -> list:
    """The devices of a mesh's cells: cell i on cuda:(i % the card count)."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(spec.n_devices)]


def multihost_worker(rank: int, world: int, rendezvous: str, ref_dir: str, bam: str, out: str,
                     device: str) -> None:
    """One rank of the multi-process path: run_bam_multihost with a routed
    genome=2 mesh on its own card counts its round-robin share of ``bam``'s
    batches; after the merge over the ranks, rank 0 writes the tables to
    ``out``."""
    import torch.distributed as dist

    from irfinder_tpu_torch.engine_mesh import MeshSpec
    from irfinder_tpu_torch.parallel import multihost as MH
    from irfinder_tpu_torch.refio.compile import CompiledRef

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    MH.initialize(rendezvous, world, rank, device=device)
    spec = MeshSpec(genome=2, routed=True)
    m = MH.run_bam_multihost(CompiledRef.load(ref_dir), bam, out, spec, devices=[dev] * spec.n_devices,
                             cap_frags=CAP_FRAGS)
    print(f"mesh: multi-process rank {rank} of {world} on {device}: counted {m.batches} batches",
          flush=True)
    dist.destroy_process_group()


def multihost_check(ref_dir: str, bam: str, tmp: str, out_a: str) -> int:
    """torch.cuda.device_count() ranks, NCCL, one card each; rank 0's
    tables must equal ``out_a``'s byte for byte.  Returns the world size."""
    import multiprocessing as mp

    world = torch.cuda.device_count()
    out = os.path.join(tmp, "multihost")
    rendezvous = "file://" + os.path.join(tmp, "multihost.rendezvous")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=multihost_worker, args=(r, world, rendezvous, ref_dir, bam, out, f"cuda:{r}"))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"multi-process ranks exited {codes}")
    same_tables(out, out_a)
    return world


def mesh_phase(ref, bam: str, out_a: str, wref, whole: dict, tmp: str, dev) -> dict:
    """The dp x genome mesh on the card (see the module docstring, phase
    7c).  Returns each mesh run's launches, by path."""
    import itertools

    from irfinder_tpu_torch import checkpoint as CK
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.engine import open_decoder, run_bam
    from irfinder_tpu_torch.engine_mesh import MeshEngine, MeshSpec, run_bam_mesh
    from irfinder_tpu_torch.ops import finalize_stats as FS

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    by_path = {}
    walls = []
    for spec_text in ("", "dp=2", "dp=2,genome=4", "dp=2,genome=4,routed", "dp=4,genome=2,routed", ""):
        out = os.path.join(tmp, f"mesh_{spec_text or 'unsharded'}_{len(walls)}")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        if not spec_text:
            m = run_bam(ref, bam, out, cap_frags=CAP_FRAGS, device=dev)
            wall = time.perf_counter() - t0
            walls.append(wall)
            expect_launches("config A run_bam (unsharded, beside the mesh)", m.batches)
            print(f"mesh: config A unsharded run_bam wall={wall:.6f} s batches={m.batches}")
            same_tables(out, out_a)
            continue
        spec = MeshSpec.parse(spec_text)
        cells = mesh_cells(spec)
        m = run_bam_mesh(ref, bam, out, spec, devices=cells, cap_frags=CAP_FRAGS)
        wall = time.perf_counter() - t0
        walls.append(wall)
        want = spec.n_devices * m.batches
        by_path[f"mesh {spec}"] = expect_launches(f"mesh {spec}", want)
        same_tables(out, out_a)
        pad = m.route_rows_padded / m.route_rows_real if m.route_rows_real else float("nan")
        print(f"mesh: config A {spec} cells->cards {[str(c) for c in cells]}: wall={wall:.6f} s "
              f"batches={m.batches} decode_s={m.decode_s:.6f} route={m.spans.get('route', 0.0):.6f} "
              f"stage={m.spans['stage']:.6f} count={m.spans['count']:.6f} finalize_s={m.finalize_s:.6f} wire_bytes={m.wire_bytes} "
              f"route_rows_padded/real={m.route_rows_padded}/{m.route_rows_real}={pad:.6f}; count_step "
              f"launches {by_path[f'mesh {spec}']['count_step']} = {spec.n_devices} cells x {m.batches} "
              f"batches, intron_stats 1; {len(TABLES)} tables byte-identical to run_bam's "
              f"(metrics.device={m.device!r})")
    print(f"mesh: config A unsharded run_bam walls before and after the mesh runs: "
          f"{walls[0]:.6f}, {walls[-1]:.6f} s")

    # the whole-genome map at genome=4, routed, cells on the card(s)
    spec = MeshSpec(genome=MESH_GENOME, routed=True)
    cells = mesh_cells(spec)
    out = os.path.join(tmp, "mesh_wg")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cards = sorted(set(cells), key=str)
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = run_bam_mesh(wref, whole["wbam"], out, spec, devices=cells, cap_frags=CAP_FRAGS)
    wall = time.perf_counter() - t0
    by_path[f"mesh {spec}, whole genome"] = expect_launches("whole-genome mesh", spec.n_devices * m.batches)
    same_tables(out, whole["full"])
    peak = "/".join(str(torch.cuda.max_memory_allocated(c)) for c in cards)
    print(f"mesh: whole-genome {spec} cells->cards {[str(c) for c in cells]}: wall={wall:.6f} s "
          f"(unsharded run_bam {whole['wall']:.6f} s) batches={m.batches} route={m.spans['route']:.6f} "
          f"route_rows_padded/real={m.route_rows_padded}/{m.route_rows_real} finalize_s={m.finalize_s:.6f} "
          f"(unsharded {whole['m'].finalize_s:.6f}) peak_mem_bytes by card={peak} (unsharded {whole['peak']}); "
          f"launches={by_path[f'mesh {spec}, whole genome']}; {len(TABLES)} tables byte-identical to the "
          f"unsharded run's")
    torch.cuda.empty_cache()
    eng = MeshEngine(wref, spec, cells, cap_frags=CAP_FRAGS)
    header, batches, _ = open_decoder(wref, whole["wbam"], CAP_FRAGS)
    st = eng.new_state(len(header.ref_names))
    eng.run_stream(batches, st)
    depth = eng.depth(eng.merged_shards(st))
    finref = FS.build_finalize_ref(wref, dev)
    err = compare_stats("the whole-genome mesh's reassembled depth", finref, depth, False, FS.CAP, FS.CHUNK)
    ms = time_ms(lambda: FS.launch_all_stats_multi(finref, [depth], [0]), 5)
    print(f"mesh: intron_stats on the whole-genome mesh's reassembled depth: {ms:.6f} ms per finalize by "
          f"CUDA events (max_abs_err={err})")
    del eng, st, depth, finref
    torch.cuda.empty_cache()

    # a mesh snapshot at config A, dp=2,genome=4,routed: half the batches,
    # snapshot, resume
    spec = MeshSpec(dp=2, genome=4, routed=True)
    cells = mesh_cells(spec)
    n_batches = by_path[f"mesh {spec}"]["count_step"] // spec.n_devices
    half = n_batches // 2
    eng = MeshEngine(ref, spec, cells, cap_frags=CAP_FRAGS)
    header, batches, _ = open_decoder(ref, bam, CAP_FRAGS)
    st = eng.new_state(len(header.ref_names))
    eng.run_stream(itertools.islice(batches, half), st)
    ck = os.path.join(tmp, "mesh_state.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    info = CK.save_checkpoint(ck, st)
    snap_s = time.perf_counter() - t0
    del eng, st, batches
    out = os.path.join(tmp, "mesh_resumed")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    mr = run_bam_mesh(ref, bam, out, spec, devices=cells, cap_frags=CAP_FRAGS, checkpoint=ck)
    wall = time.perf_counter() - t0
    launched = expect_launches(f"mesh {spec} resumed", spec.n_devices * (n_batches - half))
    same_tables(out, out_a)
    if os.path.exists(ck) or mr.batches != n_batches:
        raise AssertionError(f"mesh resume: snapshot left behind or {mr.batches} batches, not {n_batches}")
    print(f"mesh: snapshot of {spec} after {half} of {n_batches} batches: {snap_s:.6f} s = pack "
          f"{info['pack_s']:.6f} + D2H {info['d2h_s']:.6f} + write {info['write_s']:.6f} (+ tally), "
          f"{info['bytes']} file bytes, {info['escapes']} escapes; resumed wall={wall:.6f} s launches={launched} "
          f"({spec.n_devices} cells x the {n_batches - half} batches after the snapshot); {len(TABLES)} tables "
          f"byte-identical to run_bam's, snapshot removed")

    # --mesh genome=4 through the CLI, default devices
    ref_dir = os.path.join(tmp, "REF")
    if not os.path.isdir(ref_dir):
        ref.save(ref_dir)
    out = os.path.join(tmp, "mesh_cli")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    mc, _, _ = run_cli(["BAM", "-r", ref_dir, "-d", out, "--mesh", "genome=4", "--device", "cuda", bam])
    wall = time.perf_counter() - t0
    sharded = n_cards >= 4
    if mc["device"].startswith("unsharded") == sharded:
        raise AssertionError(f"--mesh genome=4 on {n_cards} card(s) took the path {mc['device']!r}")
    launched = expect_launches("cli --mesh genome=4", (4 if sharded else 1) * mc["batches"])
    same_tables(out, out_a)
    print(f"mesh: cli BAM --mesh genome=4 --device cuda on {n_cards} card(s): wall={wall:.6f} s "
          f"launches={launched}, path {mc['device']!r}; {len(TABLES)} tables byte-identical to run_bam's")

    # the multi-process path: one rank per card, NCCL
    t0 = time.perf_counter()
    world = multihost_check(ref_dir, bam, tmp, out_a)
    print(f"mesh: run_bam_multihost over {world} rank(s) (NCCL, one card each"
          f"{'; a world of 1 on this one-card host' if world == 1 else ''}), each a routed genome=2 mesh "
          f"counting its round-robin share of config A's batches, merged: {len(TABLES)} tables byte-identical "
          f"to run_bam's, {time.perf_counter() - t0:.3f} s")
    print(f"mesh: phase wall {time.perf_counter() - t_phase:.3f} s")
    return by_path


def write_gtf(path: str, exons) -> int:
    """A GTF of ``exons`` (0-based half-open -> 1-based inclusive), one exon
    line each.  Returns the line count."""
    with open(path, "w") as fh:
        fh.writelines(
            f'{e.chrom}\tsynth\texon\t{e.start + 1}\t{e.end}\t.\t{e.strand}\t.\t'
            f'gene_id "{e.gene_id}"; transcript_id "{e.transcript_id}";\n' for e in exons
        )
    return len(exons)


def write_roi_bed(path: str, ref) -> None:
    """The ROI rows of ``ref`` as a BED (chrom start end name score strand)."""
    from irfinder_tpu_torch.refio.compile import STRAND_CHAR

    with open(path, "w") as fh:
        for c in range(ref.n_chroms):
            for r in range(int(ref.roi_seg[c]), int(ref.roi_seg[c + 1])):
                fh.write(f"{ref.chroms[c]}\t{ref.roi_start[r]}\t{ref.roi_end[r]}\t{ref.roi_names[r]}\t0\t"
                         f"{STRAND_CHAR[int(ref.roi_strand[r])]}\n")


def same_ref(what: str, a, b) -> None:
    """Two CompiledRefs equal field for field."""
    import dataclasses

    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        same = (x.dtype == y.dtype and np.array_equal(x, y)) if isinstance(x, np.ndarray) else list(x) == list(y)
        if not same:
            raise AssertionError(f"{what}: field {f.name} differs")


def ir_columns(path: str) -> dict:
    """An IR table's rows as {column: [values]} (an independent reader for
    the ExportGLM check)."""
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        cols = {h: [] for h in header}
        for ln in fh:
            for h, v in zip(header, ln.rstrip("\n").split("\t")):
                cols[h].append(v)
    return cols


def mapability_fasta(path: str) -> dict:
    """One seeded MAP_LEN-base chromosome named like config A's, with a
    planted MAP_DUP_LEN-base duplicate and a MAP_N_LEN-base run of Ns, all
    inside config A's gene bodies.  Returns the planted intervals."""
    rng = np.random.default_rng(SEED)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, MAP_LEN)].copy()
    (a, b), n = MAP_DUP, MAP_N
    seq[b:b + MAP_DUP_LEN] = seq[a:a + MAP_DUP_LEN]
    seq[n:n + MAP_N_LEN] = ord("N")
    lines = seq[: MAP_LEN // 60 * 60].reshape(-1, 60)
    with open(path, "wb") as fh:
        fh.write(b">chr21 synthetic\n")
        fh.write(b"\n".join(bytes(r) for r in lines) + b"\n")
        if MAP_LEN % 60:
            fh.write(bytes(seq[MAP_LEN // 60 * 60:]) + b"\n")
    return {"dups": [(a, a + MAP_DUP_LEN), (b, b + MAP_DUP_LEN)], "n_run": (n, n + MAP_N_LEN)}


def tile_footprint(lo: int, hi: int, read_len: int, stride: int) -> tuple:
    """The union of the grid tiles [p, p + read_len) that touch [lo, hi)."""
    first = -(-max(0, lo - read_len + 1) // stride) * stride
    last = (hi - 1) // stride * stride
    return first, last + read_len


def cli_phase(ref, wref, whole: dict, batch: dict, tmp: str, dev) -> dict:
    """The user's workflow through cli.main (see the module docstring, phase
    7d).  Returns the two card paths' launches, by path."""
    import shutil

    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch import semantics as S
    from irfinder_tpu_torch.io import bamwrite
    from irfinder_tpu_torch.refio.compile import CompiledRef
    from irfinder_tpu_torch.refio.mapgen import iter_tiles, read_fasta
    from irfinder_tpu_torch.synth import synth_exons

    t_phase = time.perf_counter()
    by_path = {}
    walls = {}

    def timed(name: str, argv: list, rc: int = 0) -> tuple:
        t0 = time.perf_counter()
        got = run_cli(argv, rc)
        walls[name] = time.perf_counter() - t0
        return got

    # (a) BuildRef at full width, and both aliases on config A's annotation
    gtf, roi = os.path.join(tmp, "wg.gtf"), os.path.join(tmp, "wg_roi.bed")
    t0 = time.perf_counter()
    n_lines = write_gtf(gtf, synth_exons(**WHOLE_GENOME))
    write_roi_bed(roi, wref)
    print(f"cli: whole-genome GTF of {n_lines} exon lines ({os.path.getsize(gtf)} bytes) and a ROI BED of "
          f"{len(wref.roi_names)} rows written in {time.perf_counter() - t0:.3f} s")
    wg_ref = os.path.join(tmp, "WGREF")
    _, line, _ = timed("BuildRef whole genome", ["BuildRef", "-g", gtf, "-r", wg_ref, "--roi", roi])
    same_ref("BuildRef whole genome", CompiledRef.load(wg_ref), wref)
    print(f"cli: {line.strip()} in {walls['BuildRef whole genome']:.6f} s; field for field equal to "
          f"synth_ref(**WHOLE_GENOME)")
    gtf_a, roi_a = os.path.join(tmp, "a.gtf"), os.path.join(tmp, "a_roi.bed")
    write_gtf(gtf_a, synth_exons(n_genes=N_GENES))
    write_roi_bed(roi_a, ref)
    alias_dirs = []
    for mode in ("BuildRefProcess", "BuildRefFromSTARRef"):
        alias_dirs.append(os.path.join(tmp, f"REF_{mode}"))
        timed(mode, [mode, "-g", gtf_a, "-r", alias_dirs[-1], "--roi", roi_a])
        same_ref(mode, CompiledRef.load(alias_dirs[-1]), ref)
    if read(os.path.join(alias_dirs[0], "ref.json")) != read(os.path.join(alias_dirs[1], "ref.json")):
        raise AssertionError("BuildRefProcess and BuildRefFromSTARRef wrote different ref.json")
    print(f"cli: BuildRefProcess {walls['BuildRefProcess']:.6f} s, BuildRefFromSTARRef "
          f"{walls['BuildRefFromSTARRef']:.6f} s on config A's GTF: ref.json byte-identical, fields equal "
          f"to synth_ref(n_genes={N_GENES})")
    ref_a = alias_dirs[0]

    # (b) BAM off the built whole-genome reference
    wg_cli = os.path.join(tmp, "wg_cli")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    kernels.reset_launches()
    m, _, _ = timed("BAM", ["BAM", "-r", wg_ref, "-d", wg_cli, whole["wbam"], "--device", "cuda"])
    by_path["cli_wg_bam"] = expect_launches("cli BAM off the built whole-genome reference", m["batches"])
    same_tables(wg_cli, whole["full"])
    print(f"cli: BAM -r WGREF --device cuda wall={walls['BAM']:.6f} s (run_bam in phase 7b "
          f"{whole['wall']:.6f} s) batches={m['batches']} finalize_s={m['finalize_s']:.6f} "
          f"launches={by_path['cli_wg_bam']}; {len(TABLES)} tables byte-identical to phase 7b's")

    # (c) Batch over config D's BAMs with a differential, then Diff
    out_b = os.path.join(tmp, "batch_cli")
    torch.cuda.synchronize()
    kernels.reset_launches()
    ms, line, _ = timed("Batch", ["Batch", "-r", ref_a, "-d", out_b, *batch["bams"], "--a", "0,1,2,3",
                                  "--b", "4,5,6,7", "--device", "cuda"])
    n_batches = sum(v["batches"] for v in ms.values())
    by_path["cli_batch"] = expect_launches("cli Batch", n_batches, 1)
    dirs = [os.path.join(out_b, os.path.splitext(os.path.basename(b))[0]) for b in batch["bams"]]
    for d, want in zip(dirs, batch["outs"]):
        same_tables(d, want)
    diff_b = os.path.join(out_b, "IRFinder-Diff.txt")
    _, dline, _ = timed("Diff", ["Diff", "-a", *dirs[:4], "-b", *dirs[4:], "-d", os.path.join(tmp, "diff.txt")])
    if read(diff_b) != read(os.path.join(tmp, "diff.txt")):
        raise AssertionError("Diff's table differs from Batch's IRFinder-Diff.txt")
    print(f"cli: Batch --a 0,1,2,3 --b 4,5,6,7 --device cuda wall={walls['Batch']:.6f} s (batch phase's first "
          f"run_multi_bam {batch['wall']:.6f} s) batches={n_batches} launches={by_path['cli_batch']}; every "
          f"sample's {len(TABLES)} tables byte-identical to the batch phase's; {line}; Diff "
          f"{walls['Diff']:.6f} s byte-identical to it ({dline.strip()})")

    # (d) ExportGLM, nondir and --dir, held to the tables it reads
    conds = "A,A,A,A,B,B,B,B"
    for mode, flags in (("nondir", []), ("dir", ["--dir"])):
        glm = os.path.join(tmp, f"glm_{mode}")
        timed(f"ExportGLM {mode}", ["ExportGLM", "-d", glm, *dirs, "--conditions", conds, *flags])
        counts = ir_columns(os.path.join(glm, "GLM-counts.tsv"))
        for i, d in enumerate(dirs):
            t = ir_columns(os.path.join(d, f"IRFinder-IR-{mode}.txt"))
            name = os.path.basename(d)
            if len(counts["intron"]) != len(t["Chr"]):
                raise AssertionError(f"ExportGLM {mode}: {len(counts['intron'])} rows for {len(t['Chr'])}")
            if counts[f"{name}.IR"] != [str(round(float(v))) for v in t["IntronDepth"]]:
                raise AssertionError(f"ExportGLM {mode}: {name}.IR is not round(IntronDepth)")
            if counts[f"{name}.Splice"] != t["SpliceExact"]:
                raise AssertionError(f"ExportGLM {mode}: {name}.Splice is not SpliceExact")
        with open(os.path.join(glm, "GLM-coldata.tsv")) as fh:
            coldata = fh.read().splitlines()[1:]
        if len(coldata) != 2 * N_SAMPLES or coldata[-1].split("\t")[-1] != "B":
            raise AssertionError(f"ExportGLM {mode}: coldata {coldata}")
    print(f"cli: ExportGLM over {N_SAMPLES} samples, nondir {walls['ExportGLM nondir']:.6f} s and --dir "
          f"{walls['ExportGLM dir']:.6f} s: {len(counts['intron'])} rows each, every .IR column "
          f"round(IntronDepth) and .Splice column SpliceExact of its table, {len(coldata)} coldata rows")

    # (e) Goldens: the CLI run against phase 7b's tables, then a tampered copy
    rec = os.path.join(tmp, "goldens.json")
    timed("Goldens", ["Goldens", wg_cli, whole["full"], "--record", rec])
    with open(rec) as fh:
        if json.load(fh)["pinned"] is not True:
            raise AssertionError("Goldens: the record is not pinned")
    bad = os.path.join(tmp, "wg_tampered")
    shutil.copytree(wg_cli, bad)
    path = os.path.join(bad, "IRFinder-IR-nondir.txt")
    with open(path) as fh:
        lines = fh.readlines()
    j = lines[0].rstrip("\n").split("\t").index("IntronDepth")
    f = lines[GOLDEN_LINE - 1].rstrip("\n").split("\t")
    f[j] = str(float(f[j]) + 1.0)
    lines[GOLDEN_LINE - 1] = "\t".join(f) + "\n"
    with open(path, "w") as fh:
        fh.writelines(lines)
    _, text, _ = timed("Goldens tampered", ["Goldens", bad, whole["full"]], rc=1)
    want = f"IRFinder-IR-nondir.txt: MISMATCH at line {GOLDEN_LINE}, column IntronDepth"
    if want not in text or "MATE_OVERLAP_DOUBLE_COUNTS, MIN_MAPQ, FLAG_DROP_MASK" not in text:
        raise AssertionError(f"Goldens on the tampered copy printed {text!r}")
    print(f"cli: Goldens {walls['Goldens']:.6f} s, pinned; on a copy with IntronDepth changed at line "
          f"{GOLDEN_LINE}: exit 1 in {walls['Goldens tampered']:.6f} s, {want} and its suspect constants")

    # (f) Mapability at MAP_LEN bases: generate, a stand-in aligner, collect
    fa = os.path.join(tmp, "map.fa")
    planted = mapability_fasta(fa)
    fq, bed = os.path.join(tmp, "tiles.fq"), os.path.join(tmp, "map.bed")
    _, gline, _ = timed("Mapability generate", ["Mapability", "generate", "-f", fa, "-o", fq])
    t0 = time.perf_counter()
    seqs = read_fasta(fa)
    rl, st = S.MAPGEN_READ_LEN, S.MAPGEN_STRIDE

    def mapq(p: int) -> int:
        # a tile touching either copy of the duplicate maps with MAPQ 0
        return 0 if any(p < e and s < p + rl for s, e in planted["dups"]) else 60

    recs = [bamwrite.make_single(f"t{i}", 0, p, f"{rl}M", mapq=mapq(p))
            for i, (_, p, _) in enumerate(iter_tiles(seqs, rl, st))]
    tiles_bam = os.path.join(tmp, "tiles.bam")
    with open(tiles_bam, "wb") as fh:
        bamwrite.write_bam(fh, list(seqs), [len(v) for v in seqs.values()], recs)
    walls["stand-in BAM"] = time.perf_counter() - t0
    _, cline, _ = timed("Mapability collect", ["Mapability", "collect", "-f", fa, "-b", tiles_bam, "-o", bed])
    with open(bed) as fh:
        rows = [ln.split("\t")[:3] for ln in fh.read().splitlines()]
    want = sorted(("chr21", *tile_footprint(lo, hi, rl, st)) for lo, hi in [*planted["dups"], planted["n_run"]])
    if [(c, int(a), int(b)) for c, a, b in rows] != want:
        raise AssertionError(f"Mapability BED {rows}, not {want}")
    excl_ref = os.path.join(tmp, "REF_excluded")
    timed("BuildRef --exclude", ["BuildRef", "-g", gtf_a, "-r", excl_ref, "--roi", roi_a, "--exclude", bed])
    mbs = CompiledRef.load(excl_ref).mbs_size
    if not mbs < ref.mbs_size:
        raise AssertionError(f"BuildRef --exclude: {mbs} measured bases, not fewer than {ref.mbs_size}")
    print(f"cli: Mapability at {MAP_LEN} bases: {gline.strip()} in {walls['Mapability generate']:.6f} s; "
          f"stand-in aligner BAM of {len(recs)} records {walls['stand-in BAM']:.6f} s; {cline.strip()} in "
          f"{walls['Mapability collect']:.6f} s, exactly both copies of the duplicate and the N run {want}; "
          f"BuildRef --exclude {walls['BuildRef --exclude']:.6f} s: {mbs} measured bases (config A "
          f"{ref.mbs_size})")

    # (g) BuildRefDownload: instructions without a manifest, then a manifest
    _, _, err = timed("BuildRefDownload", ["BuildRefDownload"], rc=2)
    if "python -m irfinder_tpu_torch.cli BuildRef" not in err:
        raise AssertionError(f"BuildRefDownload printed {err!r}")
    man = os.path.join(tmp, "manifest.json")
    with open(man, "w") as fh:
        json.dump({"gtf": gtf, "fasta": fa, "roi": roi, "exclude": bed}, fh)
    _, text, _ = timed("BuildRefDownload --manifest", ["BuildRefDownload", "--manifest", man])
    if "validated OK" not in text:
        raise AssertionError(f"BuildRefDownload --manifest printed {text!r}")
    print(f"cli: BuildRefDownload exit 2 with the instructions; --manifest of (a)'s and (f)'s files "
          f"validated in {walls['BuildRefDownload --manifest']:.6f} s")
    print("cli: walls s " + " ".join(f"{k.replace(' ', '_')}={v:.6f}" for k, v in walls.items()))
    print(f"cli: phase wall {time.perf_counter() - t_phase:.3f} s")
    return by_path


def longread_geometry(ref, bam: str, long_reads: bool, tmp: str, dev) -> dict:
    """One batch geometry of phase 7e's long-read workload: count_step
    against count_step_plain on its first two decoded batches, every
    batch's lanes and the bound; a checked run_bam, LONG_WARM_RUNS warm
    ones and one under torch.profiler (count_step's device time per
    launch)."""
    from torch.profiler import ProfilerActivity, profile

    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.config import RunConfig
    from irfinder_tpu_torch.engine import open_decoder, run_bam
    from irfinder_tpu_torch.io.batch import BLOCKS_PER_FRAG, LONGREAD_BLOCKS_PER_FRAG, MIN_CAP_UNITS
    from irfinder_tpu_torch.ops.device_ref import build_device_ref

    name = "long-read geometry" if long_reads else "paired geometry"
    cfg = RunConfig(cap_frags=CAP_FRAGS, long_reads=long_reads)
    header, batches, _ = open_decoder(ref, bam, CAP_FRAGS, long_reads=long_reads)
    real = [on_card(b.device_arrays(), dev) for b in batches]
    n_refids = len(header.ref_names)
    B, F = real[0]["blk_chrom"].shape[0], real[0]["frag_chrom"].shape[0]
    bpf = LONGREAD_BLOCKS_PER_FRAG if long_reads else BLOCKS_PER_FRAG
    if (B, F) != (max(CAP_FRAGS * bpf, MIN_CAP_UNITS), CAP_FRAGS):
        raise AssertionError(f"{name}: batches of {B} block lanes and {F} fragment lanes")
    dref = build_device_ref(ref, dev)
    err = compare_count(f"the long-read workload's first two batches in the {name} ({B} block lanes, "
                        f"{F} fragment lanes)", dref, real[:2], n_refids)
    w = count_bound(f"the long-read workload in the {name}", dref, real, n_refids)
    del real, dref
    torch.cuda.empty_cache()

    out = os.path.join(tmp, "longread" if long_reads else "longread_paired")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    m = run_bam(ref, bam, out, config=cfg, device=dev)
    wall = time.perf_counter() - t0
    launched = expect_launches(f"run_bam in the {name}", m.batches)
    if m.fragments != LONG_READS or m.batches != w["n"]:
        raise AssertionError(f"{name}: {m.fragments} fragments in {m.batches} batches")
    print(f"longread: {name}: run_bam wall={wall:.6f} s reads/s={m.reads_total / wall:.1f} "
          f"batches={m.batches} launches={launched}")
    walls = []
    for i in range(LONG_WARM_RUNS):
        t0 = time.perf_counter()
        m = run_bam(ref, bam, os.path.join(tmp, f"longread_warm{i}"), config=cfg, device=dev)
        walls.append(time.perf_counter() - t0)
        print(f"longread: {name}: warm run {i}: wall={walls[-1]:.6f} s reads/s={m.reads_total / walls[-1]:.1f} "
              f"decode_s={m.decode_s:.6f} stage={m.spans['stage']:.6f} count={m.spans['count']:.6f} "
              f"sync={m.spans['sync']:.6f} finalize_s={m.finalize_s:.6f} wire_bytes={m.wire_bytes}")
    med = float(np.median(walls))
    print(f"longread: {name}: {LONG_WARM_RUNS} warm runs: median wall={med:.6f} s "
          f"reads/s={m.reads_total / med:.1f}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mp = run_bam(ref, bam, os.path.join(tmp, "longread_prof"), config=cfg, device=dev)
    count = [(e.self_device_time_total, e.count) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA and "count_step_kernel" in e.key]
    if len(count) != 1 or count[0][1] != mp.batches:
        raise AssertionError(f"{name}: count kernel entries {count} in a profiled run of {mp.batches} batches")
    ms = count[0][0] / 1e3 / count[0][1]
    print(f"longread: {name}: count_step {ms:.6f} ms device per launch (torch.profiler, {count[0][1]} "
          f"launches of {B} block lanes), at {100 * w['bound_ms'] / ms:.1f}% of its {w['bound_ms']:.6f} ms "
          f"bound by {w['bound_by']}")
    return {"out": out, "launches": launched, "max_abs_err": err, "ms": ms, "block_lanes": B,
            "batches": m.batches, "bound_ms": w["bound_ms"], "bound_by": w["bound_by"]}


def longread_phase(ref, tmp: str, dev) -> dict:
    """Phase 7e's long-read path (see the module docstring).  Returns the
    launches by path and count_step's figures in each geometry."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.conformance import write_longread_bam

    t_phase = time.perf_counter()
    bam = os.path.join(tmp, "longread.bam")
    t0 = time.perf_counter()
    mix = write_longread_bam(bam, ref, n_reads=LONG_READS, seed=LONG_SEED)
    print(f"longread: {mix.n_records} single-end records ({os.path.getsize(bam)} bytes) against config A's "
          f"map written in {time.perf_counter() - t0:.3f} s")
    geo = {lr: longread_geometry(ref, bam, lr, tmp, dev) for lr in (True, False)}
    same_tables(geo[True]["out"], geo[False]["out"])
    check_oracle_tables(ref, bam, geo[True]["out"], long_reads=True)
    run_spans("longread", ref, bam, dev, long_reads=True)
    print(f"longread: {len(TABLES)} tables byte-identical across the geometries ({geo[True]['batches']} and "
          f"{geo[False]['batches']} batches), IR-nondir IR-dir SpansPoint ROI ChrCoverage to the oracle's "
          f"over the long-read geometry's batches")

    ref_dir = os.path.join(tmp, "REF_A")
    ref.save(ref_dir)
    out_cli = os.path.join(tmp, "longread_cli")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    m, _, _ = run_cli(["BAM", "-r", ref_dir, "-d", out_cli, "--long-reads", "--device", "cuda", bam])
    wall = time.perf_counter() - t0
    cli = expect_launches("cli BAM --long-reads", m["batches"])
    same_tables(out_cli, geo[True]["out"])
    print(f"longread: cli BAM --long-reads --device cuda wall={wall:.6f} s batches={m['batches']} "
          f"launches={cli}; {len(TABLES)} tables byte-identical to run_bam's")
    print(f"longread: phase wall {time.perf_counter() - t_phase:.3f} s")
    return {
        "by_path": {"longread": geo[True]["launches"], "longread_paired_geometry": geo[False]["launches"],
                    "cli_longread": cli},
        "max_abs_err": max(g["max_abs_err"] for g in geo.values()),
        "at_shapes": {k: {f: geo[lr][f] for f in ("block_lanes", "batches", "ms", "bound_ms", "bound_by")}
                      for k, lr in (("longread", True), ("longread_paired_geometry", False))},
    }


def ir_text(rows) -> str:
    import io

    from irfinder_tpu_torch import format as fmt

    buf = io.StringIO()
    fmt.write_ir_table(buf, rows)
    return buf.getvalue()


def library_phase(ref, bam: str, out_a: str, ofc: dict, tmp: str, dev) -> dict:
    """Phase 7e's library API on the card (see the module docstring).
    Returns the launches by path."""
    from irfinder_tpu_torch import kernels
    from irfinder_tpu_torch.engine import Engine, open_decoder, write_run

    header, batches, stats = open_decoder(ref, bam, CAP_FRAGS)
    batches = list(batches)
    eng = Engine(ref, cap_frags=CAP_FRAGS, device=dev)
    eng.reset(n_refids=len(header.ref_names))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for b in batches:
        eng.process_batch(b)
    torch.cuda.synchronize(dev)
    t_pb = time.perf_counter() - t0
    t0 = time.perf_counter()
    fc = eng.counters_host()
    t_ch = time.perf_counter() - t0
    expect_launches("process_batch over config A's batches, counters_host", len(batches), 0)
    if set(fc) != set(ofc):
        raise AssertionError(f"counters_host keys {sorted(fc)}, the oracle's {sorted(ofc)}")
    for k in ofc:
        got, want = np.asarray(fc[k]), np.asarray(ofc[k])
        if got.shape != want.shape or not np.array_equal(got.astype(np.int64), want.astype(np.int64)):
            raise AssertionError(f"counters_host {k} differs from the oracle's")
    pulled = sum(np.asarray(v).nbytes for v in fc.values())
    print(f"library: Engine(cap_frags={eng.cap_frags}).process_batch x {len(batches)} in {t_pb:.6f} s; "
          f"counters_host {t_ch:.6f} s ({pulled} bytes, depth {fc['depth'].nbytes}): every counter "
          f"integer-identical to the oracle's")
    t0 = time.perf_counter()
    res = eng.results()
    t_res = time.perf_counter() - t0
    lib_out = os.path.join(tmp, "library_api")
    write_run(lib_out, ref, header, stats, eng._st, lambda: res)
    same_tables(lib_out, out_a)
    expect_launches("process_batch, results()", len(batches), 1)
    t0 = time.perf_counter()
    res_fc = eng.results(fc)
    t_fc = time.perf_counter() - t0
    by_path = expect_launches("process_batch, results(), results(fc)", len(batches), 2)
    for mode in ("nondir", "dir"):
        if ir_text(res_fc[f"rows_{mode}"]) != ir_text(res[f"rows_{mode}"]):
            raise AssertionError(f"results(fc) rows_{mode} differ from results()'s")
    print(f"library: results() {t_res:.6f} s, {len(TABLES)} tables byte-identical to run_bam's; results(fc) "
          f"{t_fc:.6f} s, one more intron_stats, rows equal; launches={by_path}")
    return {"library_api": by_path}


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
    print(f"build: {build_s:.3f} s nvcc wall, {len(kernels.SOURCES)} sources, one nvcc each, "
          f"in parallel ({ptxas or 'cached'})")

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
        rres = count_real_batches(ref, bam, dev)

        out = os.path.join(tmp, "out")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        m = run_bam(ref, bam, out, cap_frags=CAP_FRAGS, device=dev)
        wall = time.perf_counter() - t0
        launched = dict(kernels.launches)
        print(f"main path: run_bam wall={wall:.6f} s reads={m.reads_total} "
              f"reads/s={m.reads_total / wall:.1f} batches={m.batches} "
              f"decode_s={m.decode_s:.6f} stage={m.spans['stage']:.6f} count={m.spans['count']:.6f} "
              f"sync={m.spans['sync']:.6f} finalize_s={m.finalize_s:.6f} decoder={decoder} "
              f"metrics.device={m.device!r} launches={launched} "
              f"peak_mem_bytes={torch.cuda.max_memory_allocated(dev)}")
        if launched["count_step"] != m.batches or m.batches == 0:
            raise AssertionError(f"count_step launched {launched} for {m.batches} batches")
        if launched["intron_stats"] != 1:
            raise AssertionError(f"intron_stats launched {launched['intron_stats']} times in "
                                 f"one finalize, not once: {launched}")

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
        fastq_phase(ref, bam, out, tmp, dev)
        batch = batch_phase(ref, bam, tmp, dev)
        in_run_ms = measure(ref, bam, dev)
        torch.cuda.empty_cache()
        whole = whole_genome_run(cres["wref"], tmp, dev)
        checkpoint_phase(cres["wref"], whole, tmp, dev)
        torch.cuda.empty_cache()
        cohort = cohort_phase(cres["wref"], tmp, dev)
        torch.cuda.empty_cache()
        mesh_launches = mesh_phase(ref, bam, out, cres["wref"], whole, tmp, dev)
        torch.cuda.empty_cache()
        cli_launches = cli_phase(ref, cres["wref"], whole, batch, tmp, dev)
        torch.cuda.empty_cache()
        lres = longread_phase(ref, tmp, dev)
        lib_launches = library_phase(ref, bam, out, ofc, tmp, dev)
    print(f"kernels: count_step {in_run_ms:.6f} ms per launch in the run, at "
          f"{100 * rres['bound_ms'] / in_run_ms:.1f}% of its {rres['bound_ms']:.6f} ms bound")

    print(json.dumps({"kernels": [{
        "name": "count_step",
        "route": "cuda",
        "source": "irfinder_tpu_torch/csrc/count.cu",
        "replaces": "irfinder_tpu/ops/pallas_rank.py:385 + irfinder_tpu/ops/scatter.py:107",
        "launches": launched["count_step"],
        "launches_by_path": {"run_bam": launched["count_step"],
                             "run_multi_bam": batch["launches"]["count_step"],
                             "run_multi_bam_wg_cohort": cohort["launches"]["count_step"],
                             **{k: v["count_step"] for k, v in mesh_launches.items()},
                             **{k: v["count_step"] for k, v in cli_launches.items()},
                             **{k: v["count_step"] for k, v in lres["by_path"].items()},
                             **{k: v["count_step"] for k, v in lib_launches.items()}},
        "at_shapes": lres["at_shapes"],  # per launch in each long-read geometry's profiled run
        "max_abs_err": max(cres["max_abs_err"], rres["max_abs_err"], lres["max_abs_err"]),
        "ms": in_run_ms,  # per launch, inside the profiled run_bam
        "plain_ms": rres["plain_ms"],  # per batch, over config A's batches in turn
        "bound_ms": rres["bound_ms"],
        "bound_by": rres["bound_by"],
        "library_ms": None,  # no one PyTorch call computes the fused count step
    }, {
        "name": "intron_stats",
        "route": "cuda",
        "source": "irfinder_tpu_torch/csrc/stats.cu",
        "replaces": "irfinder_tpu/ops/gather.py:95 + irfinder_tpu/ops/scatter.py:233",
        "launches": launched["intron_stats"],
        "launches_by_path": {"run_bam": launched["intron_stats"],
                             "run_multi_bam": batch["launches"]["intron_stats"],
                             "run_multi_bam_wg_cohort": cohort["launches"]["intron_stats"],
                             **{k: v["intron_stats"] for k, v in mesh_launches.items()},
                             **{k: v["intron_stats"] for k, v in cli_launches.items()},
                             **{k: v["intron_stats"] for k, v in lres["by_path"].items()},
                             **{k: v["intron_stats"] for k, v in lib_launches.items()}},
        "at_config_d": {k: batch["stats"][k] for k in ("n_samples", "ms", "singles_ms", "device_ms",
                                                        "singles_device_ms", "bound_ms")},
        "max_abs_err": max(sres["max_abs_err"], batch["stats"]["max_abs_err"]),
        "ms": sres["ms"],
        "plain_ms": sres["plain_ms"],
        "bound_ms": sres["bound_ms"],
        "bound_by": sres["bound_by"],
        "library_ms": None,  # no one PyTorch call computes the per-intron statistics
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
