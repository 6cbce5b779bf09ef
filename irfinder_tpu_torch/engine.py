"""Engine: BAM streams -> counting on the device -> output tables.

Port of irfinder_tpu/engine.py's ``-m BAM`` path and its batch mode.  Each
sample has one feeder thread: it pulls PackedBatches from the host decoder,
stages each fused batch buffer in pinned memory and copies it to the card on
a side CUDA stream.  The consumer waits for that copy, slices the buffer
(unpack_fused) and runs the counting step (ops/step.py) on the current
stream, each sample counting into its own state.  ``run_bam`` is the
one-sample case of batch mode's pipeline (run_multi_bam).

Finalize cumsums the diff sections on the device, joins the junction counts
on the host, then computes every per-intron depth statistic on the device
(ops/finalize_stats.py) and pulls only the packed per-intron rows: the depth
never leaves the card.  The tables come from the port's finalize and
format modules.

RunMetrics, SampleState, the queue helpers, open_decoder, write_outputs and
run_multi_bam's decoder-thread budget are copied from irfinder_tpu/engine.py.

Not ported yet: checkpoint/resume, the mesh.  The TPU transfer workarounds
(link probe, deferred window, wire format, auto-binning, finref prewarm) are
not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterable

import torch

from . import format as fmt
from .finalize import detect_directionality, intron_table, junction_counters
from .io.bampy import BamHeader, decode_bam
from .io.batch import PackedBatch, unpack_fused
from .junctions import JuncTally
from .ops.device_ref import DeviceRef, build_device_ref
from .ops.finalize_stats import build_finalize_ref, device_all_stats_async, pull_async
from .ops.step import count_step, finalize_device, init_counters
from .qc import qc_warnings, write_warnings
from .refio.compile import CompiledRef


@dataclasses.dataclass
class RunMetrics:
    """Structured run metrics written next to the outputs (SURVEY.md §5.5).
    The count fields and the stage timings carry the JAX package's names;
    the TPU route, wire-rate and checkpoint fields are left out until the
    paths that set them are ported."""

    #: the torch device the run counted on, with the card's name on CUDA
    device: str = ""
    reads_total: int = 0
    reads_admitted: int = 0
    fragments: int = 0
    batches: int = 0
    decode_s: float = 0.0
    #: feeder time staging and enqueueing batch copies
    h2d_s: float = 0.0
    #: consumer time enqueueing steps plus the end-of-stream device sync
    device_s: float = 0.0
    finalize_s: float = 0.0
    #: bytes of fused batch buffers shipped host -> device
    wire_bytes: int = 0
    #: end-of-stream device synchronize wall (a subset of device_s)
    sync_s: float = 0.0
    #: batch mode phase walls, the same on every sample's metrics: the
    #: run_multi_stream wall and the finalize drain wall (all samples'
    #: statistics and JuncCount tables, before the other tables are written)
    multi_stream_s: float = 0.0
    multi_finalize_s: float = 0.0
    is_stranded: bool = False
    flip_strand: bool = False
    dir_concordance: float = 0.0
    dir_informative: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class SampleState:
    """Per-sample accumulation state."""

    counters: dict
    junc_tally: JuncTally = dataclasses.field(default_factory=JuncTally)
    metrics: RunMetrics = dataclasses.field(default_factory=RunMetrics)


#: end-of-stream marker of the pipelined stream
STREAM_END = object()


def q_put(q, item, stop) -> bool:
    """Stop-aware queue put: a consumer error must never leave a feeder
    blocked on a full queue (the finally-join would hang forever)."""
    import queue as _queue

    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except _queue.Full:
            continue
    return False


class Engine:
    """One reference map on one device; per-sample state in SampleState
    (reset() makes the default one, new_state() one per batch sample).

    ``device`` defaults to the card.  Without one, "cuda" raises: counting
    on the CPU has to be asked for (``device="cpu"``)."""

    def __init__(self, ref: CompiledRef, device="cuda"):
        self.ref = ref
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device (torch.cuda.is_available() is False); "
                "pass device='cpu' to count on the CPU"
            )
        self.dref: DeviceRef = build_device_ref(ref, self.device)
        self._st: SampleState | None = None

    def new_state(self, n_refids: int) -> SampleState:
        dev = str(self.device)
        if self.device.type == "cuda":
            dev += " " + torch.cuda.get_device_name(self.device)
        return SampleState(
            counters=init_counters(self.dref, n_refids), metrics=RunMetrics(device=dev)
        )

    def reset(self, n_refids: int) -> None:
        self._st = self.new_state(n_refids)

    @property
    def counters(self):
        return self._st.counters

    @property
    def junc_tally(self) -> JuncTally:
        return self._st.junc_tally

    @property
    def metrics(self) -> RunMetrics:
        return self._st.metrics

    def _ship(self, b: PackedBatch, side):
        """Host batch -> (device buffer, copy-done event or None)."""
        if not b.columns_full:
            raise RuntimeError(
                "wire-only decoder batch (columns_full=False): its "
                "block/frag columns were never filled (open the "
                "decoder with full_columns=True)"
            )
        fz = b.fused_h2d()
        if self.device.type != "cuda":
            return torch.from_numpy(fz), None
        # the caching host allocator keeps this pinned block until the copy
        # recorded on `side` completes, so it is never reused too early
        pinned = torch.empty(fz.shape[0], dtype=torch.int32, pin_memory=True)
        pinned.numpy()[:] = fz
        with torch.cuda.stream(side):
            flat = pinned.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return flat, done

    def _count(self, st: SampleState, b: PackedBatch, flat, done) -> None:
        """Consumer side of one shipped batch: wait for its copy, run the
        step on the current stream, tally its junctions."""
        t0 = time.perf_counter()
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            # flat was allocated on the side stream: keep its memory
            # until this stream's step has read it
            flat.record_stream(cur)
        count_step(self.dref, st.counters, unpack_fused(flat, b.cap_blocks, b.cap_frags))
        st.metrics.device_s += time.perf_counter() - t0
        st.metrics.batches += 1
        st.junc_tally.add_batch(b)

    def _sync(self, m: RunMetrics) -> None:
        """End-of-stream device synchronize, charged to ``m``."""
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            m.device_s += dt
            m.sync_s += dt

    def run_stream(self, batches: Iterable[PackedBatch]) -> None:
        """Count one sample's batches into the default state: the one-sample
        case of run_multi_stream."""
        self.run_multi_stream([(batches, self._st)])

    def run_multi_stream(self, streams: "list[tuple]") -> None:
        """The counting pipeline: one feeder thread per sample (decode, with
        the native decoder releasing the GIL, then the fused H2D on that
        sample's own side stream), all draining into one bounded queue
        consumed by this thread's step launches.  Arrival order is
        irrelevant: counters are per-sample and add-associative.

        streams: list of (batch_iterable, SampleState).  Each sample's
        decode_s is its feeder's blocking time in its decoder (feeders
        overlap, so the sum can exceed the wall).  The one end-of-stream
        synchronize is charged to the sample whose batch ran last."""
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=max(4, 2 * len(streams)))
        stop = threading.Event()
        cuda = self.device.type == "cuda"

        def feeder(batches, st, side):
            m = st.metrics
            try:
                it = iter(batches)
                while True:
                    t0 = time.perf_counter()
                    try:
                        b = next(it)
                    except StopIteration:
                        break
                    m.decode_s += time.perf_counter() - t0
                    t0 = time.perf_counter()
                    flat, done = self._ship(b, side)
                    m.wire_bytes += flat.numel() * 4
                    m.h2d_s += time.perf_counter() - t0
                    if not q_put(q, (st, b, flat, done), stop):
                        return
                q_put(q, STREAM_END, stop)
            except BaseException as e:  # surfaced on the consumer side
                q_put(q, e, stop)

        threads = [
            threading.Thread(
                target=feeder,
                args=(it_, st_, torch.cuda.Stream(self.device) if cuda else None),
                daemon=True,
            )
            for it_, st_ in streams
        ]
        for t in threads:
            t.start()
        live = len(streams)
        last = streams[0][1] if streams else None
        try:
            while live:
                item = q.get()
                if item is STREAM_END:
                    live -= 1
                    continue
                if isinstance(item, BaseException):
                    raise item
                last = item[0]
                self._count(*item)
            if last is not None:
                self._sync(last.metrics)
        finally:
            # a consumer error must not leave the feeders blocked on a full
            # queue holding their decoders open
            stop.set()
            for t in threads:
                t.join()

    def results_async(self, st: SampleState | None = None):
        """Launch the device finalize without blocking and return a zero-arg
        callable that waits for the pulls and builds the result bundle.

        The host junction join and directionality call overlap the device
        cumsums; directionality then decides which depth plane feeds subset
        A, and the per-intron statistics launch on the card.  Only the
        packed stats rows and the small counters come back, each in one
        pinned D2H; the depth stays on the card (``counters["depth"]`` is
        None)."""
        st = st or self._st
        m = st.metrics
        t0 = time.perf_counter()
        fin = finalize_device(self.dref, st.counters)
        sc, ec, xc = junction_counters(self.ref, st.junc_tally)
        stranded, flip, frac, n_inf = detect_directionality(self.ref, xc)
        m.is_stranded = bool(stranded)
        m.flip_strand = bool(flip)
        m.dir_concordance = float(frac)
        m.dir_informative = int(n_inf)
        stats = device_all_stats_async(
            self.ref, build_finalize_ref(self.ref, self.device), fin["depth"], bool(flip)
        )
        small = {k: pull_async(v.contiguous()) for k, v in fin.items() if k != "depth"}
        m.finalize_s += time.perf_counter() - t0

        def finish() -> dict:
            t1 = time.perf_counter()
            fc = {k: get() for k, get in small.items()}
            fc["depth"] = None  # never pulled: the statistics ran on the card
            fc["start_cnt"], fc["end_cnt"], fc["exact_cnt"] = sc, ec, xc
            cache = stats()
            args = (self.ref, None, sc, ec, xc, fc["span_hits"])
            out = {
                "counters": fc,
                "rows_nondir": intron_table(*args, mode="nondir", stats_cache=cache),
                "rows_dir": intron_table(
                    *args, mode="dir", flip_strand=flip, stats_cache=cache
                ),
                "stranded": stranded,
                "flip_strand": flip,
            }
            m.finalize_s += time.perf_counter() - t1
            return out

        return finish


def open_decoder(
    ref: CompiledRef,
    bam,
    cap_frags: int = 1 << 15,
    use_native: bool = True,
    n_threads: int = 4,
    long_reads: bool = False,
):
    """Pick the decoder: the multithreaded native C++ decoder for file paths,
    the pure-Python decoder for file objects or when the native toolchain is
    unavailable.  Both emit identical batch streams with every column filled
    (the port ships fused columns, never the TPU wire format)."""
    from .io.batch import (
        BLOCKS_PER_FRAG, GAPS_PER_FRAG,
        LONGREAD_BLOCKS_PER_FRAG, LONGREAD_GAPS_PER_FRAG,
    )

    bpf = LONGREAD_BLOCKS_PER_FRAG if long_reads else BLOCKS_PER_FRAG
    gpf = LONGREAD_GAPS_PER_FRAG if long_reads else GAPS_PER_FRAG
    chrom_index = {c: i for i, c in enumerate(ref.chroms)}
    if isinstance(bam, (str, os.PathLike)):
        if use_native:
            try:
                from .native.bamdecode import decode_bam_native

                return decode_bam_native(
                    str(bam), chrom_index, cap_frags=cap_frags,
                    n_threads=n_threads,
                    blocks_per_frag=bpf, gaps_per_frag=gpf,
                )
            except (RuntimeError, OSError, AssertionError):
                pass  # no toolchain / build failure: fall through to Python
        bam = open(bam, "rb")
    elif use_native:
        # a pipe/file object with a real descriptor whose Python-level buffer
        # is untouched rides the native multithreaded decoder
        fd = None
        try:
            fd = bam.fileno()
        except (OSError, ValueError, AttributeError):
            fd = None  # BytesIO / wrappers: no descriptor
        if fd is not None:
            try:
                if bam.tell() != 0:
                    fd = None  # partially-consumed file object
            except (OSError, ValueError):
                pass  # unseekable pipe: fresh by construction
        if fd is not None:
            try:
                from .native.bamdecode import decode_bam_native_fd, load_library

                load_library()
            except (RuntimeError, OSError, AssertionError):
                pass  # no native library: the stream is untouched
            else:
                # past this point the native side consumes bytes from the
                # descriptor: a failure must surface, not fall back
                tee_fd = getattr(bam, "irtpu_tee_fd", -1)
                return decode_bam_native_fd(
                    fd, chrom_index, cap_frags=cap_frags,
                    n_threads=n_threads, blocks_per_frag=bpf,
                    gaps_per_frag=gpf, tee_fd=tee_fd,
                )
    return decode_bam(
        bam, chrom_index, cap_frags=cap_frags, blocks_per_frag=bpf, gaps_per_frag=gpf,
    )


def run_bam(
    ref: CompiledRef,
    bam,
    out_dir: str,
    cap_frags: int = 1 << 15,
    use_native: bool = True,
    checkpoint: str | None = None,
    config=None,
    device="cuda",
) -> RunMetrics:
    """The ``-m BAM`` counting path: count one aligner-ordered BAM (path or
    file object) against a compiled reference and write the full output
    table set.  ``config`` (config.RunConfig) overrides the
    keyword knobs when given.  ``device`` is the card unless told otherwise;
    without a card the default raises.  Checkpointing is not ported yet and
    raises."""
    n_threads = 4
    long_reads = False
    if config is not None:
        cap_frags = config.cap_frags
        use_native = config.use_native
        checkpoint = config.checkpoint
        if config.decoder_threads is not None:
            n_threads = config.decoder_threads
        long_reads = config.long_reads
    if checkpoint:
        raise NotImplementedError("checkpoint/resume is not yet ported to irfinder_tpu_torch")
    engine = Engine(ref, device=device)
    header, batches, stats = open_decoder(
        ref, bam, cap_frags, use_native, n_threads, long_reads=long_reads,
    )
    engine.reset(n_refids=len(header.ref_names))
    engine.run_stream(batches)
    # the finalize runs on the device while the stats-independent JuncCount
    # table is written
    finish = engine.results_async()
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "IRFinder-JuncCount.txt"), "w") as fh:
        fmt.write_junc_count(fh, ref.chroms, engine.junc_tally)
    res = finish()
    engine.metrics.reads_total = stats.reads_total
    engine.metrics.reads_admitted = stats.reads_admitted
    engine.metrics.fragments = stats.fragments
    write_outputs(out_dir, ref, header, res, engine.metrics)
    return engine.metrics


def run_multi_bam(
    ref: CompiledRef,
    bams: "list[str]",
    out_dirs: "list[str]",
    cap_frags: int = 1 << 15,
    use_native: bool = True,
    device="cuda",
) -> "list[RunMetrics]":
    """Multi-sample batch mode (BASELINE config D): stream N BAMs
    concurrently through ONE Engine, each sample counting into its own
    SampleState, and write each sample's table set into its out_dir.

    Every sample gets its own feeder thread (decode + fused H2D) into one
    consumer; each sample's statistics then launch on its own depth (no
    stacked copy of the N depths).  ``multi_stream_s`` and
    ``multi_finalize_s`` are set before the tables and metrics.json are
    written."""
    if len(bams) != len(out_dirs):
        raise ValueError("bams and out_dirs must pair up")
    # global decoder-thread budget: ~2 inflate threads per vCPU across ALL
    # samples; feeder threads mostly block in the decoder and do not count
    # against it
    n_threads = max(1, (2 * (os.cpu_count() or 4)) // max(1, len(bams)))
    engine = Engine(ref, device=device)
    streams = []
    for path in bams:
        header, batches, stats = open_decoder(ref, path, cap_frags, use_native, n_threads)
        st = engine.new_state(n_refids=len(header.ref_names))
        streams.append((batches, st, header, stats))

    t0 = time.perf_counter()
    engine.run_multi_stream([(it_, st) for it_, st, _, _ in streams])
    stream_wall = time.perf_counter() - t0

    t0 = time.perf_counter()
    results = []
    finishes = [engine.results_async(st) for _, st, _, _ in streams]
    for (_, st, _, stats), out_dir, finish in zip(streams, out_dirs, finishes):
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "IRFinder-JuncCount.txt"), "w") as fh:
            fmt.write_junc_count(fh, ref.chroms, st.junc_tally)
        results.append(finish())
        st.metrics.reads_total = stats.reads_total
        st.metrics.reads_admitted = stats.reads_admitted
        st.metrics.fragments = stats.fragments
    fin_wall = time.perf_counter() - t0

    out_metrics = []
    for (_, st, header, _), out_dir, res in zip(streams, out_dirs, results):
        st.metrics.multi_stream_s = stream_wall
        st.metrics.multi_finalize_s = fin_wall
        write_outputs(out_dir, ref, header, res, st.metrics)
        out_metrics.append(st.metrics)
    return out_metrics


def write_outputs(
    out_dir: str, ref: CompiledRef, header: BamHeader, res: dict, metrics: RunMetrics
) -> None:
    """Every table but IRFinder-JuncCount.txt (run_bam writes that one while
    the finalize runs), WARNINGS and metrics.json."""
    fc = res["counters"]
    with open(os.path.join(out_dir, "IRFinder-IR-nondir.txt"), "w") as fh:
        fmt.write_ir_table(fh, res["rows_nondir"])
    with open(os.path.join(out_dir, "IRFinder-IR-dir.txt"), "w") as fh:
        fmt.write_ir_table(fh, res["rows_dir"])
    with open(os.path.join(out_dir, "IRFinder-SpansPoint.txt"), "w") as fh:
        fmt.write_spans_point(fh, ref, fc["span_hits"])
    with open(os.path.join(out_dir, "IRFinder-ROI.txt"), "w") as fh:
        fmt.write_roi(fh, ref, fc["roi_cnt"])
    with open(os.path.join(out_dir, "IRFinder-ChrCoverage.txt"), "w") as fh:
        fmt.write_chr_coverage(fh, header.ref_names, fc["chr_frag"])
    with open(os.path.join(out_dir, "WARNINGS"), "w") as fh:
        write_warnings(fh, qc_warnings(ref, fc, metrics))
    with open(os.path.join(out_dir, "metrics.json"), "w") as fh:
        json.dump(metrics.as_dict(), fh, indent=1)
