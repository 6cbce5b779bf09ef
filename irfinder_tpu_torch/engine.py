"""Engine: BAM stream -> counting on the device -> output tables.

Port of irfinder_tpu/engine.py's single-sample ``-m BAM`` path.  A decode
thread pulls PackedBatches from the host decoder; an H2D thread stages each
fused batch buffer in pinned memory and copies it to the card on a side CUDA
stream; the consumer waits for that copy, slices the buffer (unpack_fused)
and runs the counting step (ops/step.py) on the current stream.  Finalize
cumsums the diff sections on the device and joins on the host with the
shared ``irfinder_tpu.finalize`` code, using the host depth statistics.

``irfinder_tpu.engine`` imports jax, so its numpy-only pieces (RunMetrics,
SampleState, the queue helpers, open_decoder and
write_outputs) are copied here.

Not ported yet: batch mode, checkpoint/resume, the mesh, the device finalize
statistics.  The TPU transfer workarounds (link probe, deferred window, wire
format, auto-binning, finref prewarm) are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Iterable

import torch

from irfinder_tpu import format as fmt
from irfinder_tpu.finalize import detect_directionality, intron_table, junction_counters
from irfinder_tpu.io.bampy import BamHeader, decode_bam
from irfinder_tpu.io.batch import PackedBatch, unpack_fused
from irfinder_tpu.junctions import JuncTally
from irfinder_tpu.qc import qc_warnings, write_warnings
from irfinder_tpu.refio.compile import CompiledRef

from .ops.device_ref import DeviceRef, build_device_ref
from .ops.step import count_step, finalize_device, init_counters


@dataclasses.dataclass
class RunMetrics:
    """Structured run metrics written next to the outputs (SURVEY.md §5.5).
    The count fields and the stage timings carry the JAX package's names;
    the TPU route, wire-rate, checkpoint and multi-sample fields are left
    out until the paths that set them are ported."""

    #: the torch device the run counted on, with the card's name on CUDA
    device: str = ""
    reads_total: int = 0
    reads_admitted: int = 0
    fragments: int = 0
    batches: int = 0
    decode_s: float = 0.0
    #: H2D thread time staging and enqueueing batch copies
    h2d_s: float = 0.0
    #: consumer time enqueueing steps plus the end-of-stream device sync
    device_s: float = 0.0
    finalize_s: float = 0.0
    #: bytes of fused batch buffers shipped host -> device
    wire_bytes: int = 0
    #: end-of-stream device synchronize wall (a subset of device_s)
    sync_s: float = 0.0
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


def q_get(q, stop):
    """Stop-aware queue get for intermediate pipeline stages; returns
    STREAM_END once stopped so the stage exits cleanly."""
    import queue as _queue

    while True:
        try:
            return q.get(timeout=0.5)
        except _queue.Empty:
            if stop.is_set():
                return STREAM_END


class Engine:
    """One reference map on one device; per-sample state in SampleState."""

    def __init__(self, ref: CompiledRef, device=None):
        self.ref = ref
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self.dref: DeviceRef = build_device_ref(ref, self.device)
        self._st: SampleState | None = None

    def reset(self, n_refids: int) -> None:
        dev = str(self.device)
        if self.device.type == "cuda":
            dev += " " + torch.cuda.get_device_name(self.device)
        self._st = SampleState(
            counters=init_counters(self.dref, n_refids), metrics=RunMetrics(device=dev)
        )

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

    def run_stream(self, batches: Iterable[PackedBatch]) -> None:
        """Three-stage pipeline: a decode thread pulls batches (the native
        decoder releases the GIL), an H2D thread ships each fused buffer on a
        side stream, and the consumer waits for the copy, runs the step and
        tallies junctions.  Bounded two-batch queues between stages."""
        import queue
        import threading

        q1: "queue.Queue" = queue.Queue(maxsize=2)  # decode -> h2d
        q2: "queue.Queue" = queue.Queue(maxsize=2)  # h2d -> consumer
        stop = threading.Event()
        st = self._st
        m = st.metrics
        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None

        def decode_feeder():
            try:
                it = iter(batches)
                while True:
                    t0 = time.perf_counter()
                    try:
                        b = next(it)
                    except StopIteration:
                        break
                    m.decode_s += time.perf_counter() - t0
                    if not q_put(q1, b, stop):
                        return
                q_put(q1, STREAM_END, stop)
            except BaseException as e:  # surfaced on the consumer side
                q_put(q1, e, stop)

        def h2d_feeder():
            try:
                while True:
                    item = q_get(q1, stop)
                    if item is STREAM_END or isinstance(item, BaseException):
                        q_put(q2, item, stop)
                        return
                    if not item.columns_full:
                        raise RuntimeError(
                            "wire-only decoder batch (columns_full=False): its "
                            "block/frag columns were never filled (open the "
                            "decoder with full_columns=True)"
                        )
                    t0 = time.perf_counter()
                    flat, done = self._ship(item, side)
                    m.wire_bytes += flat.numel() * 4
                    m.h2d_s += time.perf_counter() - t0
                    if not q_put(q2, (item, flat, done), stop):
                        return
            except BaseException as e:
                q_put(q2, e, stop)

        t_dec = threading.Thread(target=decode_feeder, daemon=True)
        t_h2d = threading.Thread(target=h2d_feeder, daemon=True)
        t_dec.start()
        t_h2d.start()
        try:
            while True:
                item = q2.get()
                if item is STREAM_END:
                    break
                if isinstance(item, BaseException):
                    raise item
                b, flat, done = item
                t0 = time.perf_counter()
                if done is not None:
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(done)
                    # flat was allocated on the side stream: keep its memory
                    # until this stream's step has read it
                    flat.record_stream(cur)
                count_step(self.dref, st.counters, unpack_fused(flat, b.cap_blocks, b.cap_frags))
                m.device_s += time.perf_counter() - t0
                m.batches += 1
                st.junc_tally.add_batch(b)
            if cuda:
                t0 = time.perf_counter()
                torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t0
                m.device_s += dt
                m.sync_s += dt
        finally:
            # a consumer error must not leave the feeders blocked on full
            # queues holding the decoder open
            stop.set()
            t_dec.join()
            t_h2d.join()

    def results_async(self):
        """Dispatch the device finalize without blocking and return a
        zero-arg callable that pulls the counters and builds the result
        bundle.  The host junction join and directionality call overlap the
        device cumsums.  Per-intron statistics run on the host
        (finalize._depth_stats_vectorized)."""
        st = self._st
        t0 = time.perf_counter()
        fin = finalize_device(self.dref, st.counters)
        sc, ec, xc = junction_counters(self.ref, st.junc_tally)
        stranded, flip, frac, n_inf = detect_directionality(self.ref, xc)
        st.metrics.is_stranded = bool(stranded)
        st.metrics.flip_strand = bool(flip)
        st.metrics.dir_concordance = float(frac)
        st.metrics.dir_informative = int(n_inf)
        st.metrics.finalize_s += time.perf_counter() - t0

        def finish() -> dict:
            t1 = time.perf_counter()
            fc = {k: v.contiguous().cpu().numpy() for k, v in fin.items()}
            fc["start_cnt"], fc["end_cnt"], fc["exact_cnt"] = sc, ec, xc
            cache: dict = {}
            args = (self.ref, fc["depth"], sc, ec, xc, fc["span_hits"])
            out = {
                "counters": fc,
                "rows_nondir": intron_table(*args, mode="nondir", stats_cache=cache),
                "rows_dir": intron_table(
                    *args, mode="dir", flip_strand=flip, stats_cache=cache
                ),
                "stranded": stranded,
                "flip_strand": flip,
            }
            st.metrics.finalize_s += time.perf_counter() - t1
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
    from irfinder_tpu.io.batch import (
        BLOCKS_PER_FRAG, GAPS_PER_FRAG,
        LONGREAD_BLOCKS_PER_FRAG, LONGREAD_GAPS_PER_FRAG,
    )

    bpf = LONGREAD_BLOCKS_PER_FRAG if long_reads else BLOCKS_PER_FRAG
    gpf = LONGREAD_GAPS_PER_FRAG if long_reads else GAPS_PER_FRAG
    chrom_index = {c: i for i, c in enumerate(ref.chroms)}
    if isinstance(bam, (str, os.PathLike)):
        if use_native:
            try:
                from irfinder_tpu.native.bamdecode import decode_bam_native

                return decode_bam_native(
                    str(bam), chrom_index, cap_frags=cap_frags,
                    n_threads=n_threads,
                    blocks_per_frag=bpf, gaps_per_frag=gpf,
                    full_columns=True,
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
                from irfinder_tpu.native.bamdecode import decode_bam_native_fd, load_library

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
                    full_columns=True,
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
    device=None,
) -> RunMetrics:
    """The ``-m BAM`` counting path: count one aligner-ordered BAM (path or
    file object) against a compiled reference and write the full output
    table set.  ``config`` (irfinder_tpu.config.RunConfig) overrides the
    keyword knobs when given.  ``device`` defaults to the card when there is
    one; ``metrics.device`` names the device the run took.  Checkpointing
    is not ported yet and raises."""
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
    # the finalize cumsums run on the device while the stats-independent
    # JuncCount table is written
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
