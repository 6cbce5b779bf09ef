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

``run_bam(checkpoint=...)`` snapshots a sample's state between steps on
the consumer thread (checkpoint.py) and resumes from a snapshot: by its
decoder token, a seek, or, for a snapshot without one, by decoding again and
skipping the batches already counted.

A library caller can also drive the engine one batch at a time, as the
JAX package's Engine is driven: ``process_batch`` counts one PackedBatch on
the caller's thread through the same code as the stream, ``counters_host``
pulls every counter (the depth included) to host numpy, and
``results(fc)`` finalizes those host counters, its statistics again in one
``intron_stats`` launch on the engine's device.  Batch mode finalizes its
samples together (``results_multi_async``): one ``intron_stats`` launch
and one pull of the small counters for all of them.

RunMetrics, SampleState, the queue helpers, open_decoder, write_outputs, the
snapshot cadence and run_multi_bam's decoder-thread budget are copied from
irfinder_tpu/engine.py.  The dp x genome mesh (``--mesh``) is
engine_mesh.py; it reuses this module's pipeline pieces (ship, wait_copy,
the feeder and consumer loops feed/stage/drain, snapshot_cadence, the
finalize's stats_async, write_run).

The TPU transfer workarounds (link probe, deferred window, wire format,
auto-binning, finref prewarm) are not ported.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Iterable

import numpy as np
import torch

from . import format as fmt
from .finalize import detect_directionality, intron_table, junction_counters
from .io.bampy import BamHeader, decode_bam
from .io.batch import PackedBatch, unpack_fused
from .junctions import JuncTally
from .ops.device_ref import DeviceRef, build_device_ref
from .ops.finalize_stats import (
    build_finalize_ref, device_all_stats_async, device_all_stats_multi_async, pull_async,
)
from .ops.step import count_step, depth_on_device, finalize_device, init_counters
from .qc import qc_warnings, write_warnings
from .refio.compile import CompiledRef


@dataclasses.dataclass
class RunMetrics:
    """Structured run metrics written next to the outputs (SURVEY.md §5.5).
    The count fields and the stage timings carry the JAX package's names;
    its wire-rate fields are left out (the TPU link probe is not ported)."""

    #: the torch device the run counted on, with the card's name on CUDA
    device: str = ""
    reads_total: int = 0
    reads_admitted: int = 0
    fragments: int = 0
    batches: int = 0
    #: BGZF blocks the native decoder inflated in this run (0 from the
    #: Python decoder): a resume inflates only the blocks after its token
    blocks_inflated: int = 0
    decode_s: float = 0.0
    #: feeder time staging and enqueueing batch copies
    h2d_s: float = 0.0
    #: consumer time enqueueing steps plus the end-of-stream device sync
    device_s: float = 0.0
    finalize_s: float = 0.0
    #: seconds spent writing snapshots, and how many the cadence wrote
    checkpoint_s: float = 0.0
    checkpoints: int = 0
    #: bytes of fused batch buffers shipped host -> device
    wire_bytes: int = 0
    #: end-of-stream device synchronize wall (a subset of device_s)
    sync_s: float = 0.0
    #: mesh (engine_mesh.py) routed modes: feeder time partitioning batches
    #: by owning chromosome, the real fragment rows routed and the rows the
    #: routed cells hold padded (their ratio is the routing's padding)
    route_s: float = 0.0
    route_rows_real: int = 0
    route_rows_padded: int = 0
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
    #: decoder token of the last batch counted (io/bampy.py resume-token
    #: format): snapshotting it makes resume a seek, not a re-decode
    resume_token: bytes | None = None


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
    """Stop-aware queue get for a middle pipeline stage: returns STREAM_END
    once ``stop`` is set, so the stage exits instead of waiting forever."""
    import queue as _queue

    while not stop.is_set():
        try:
            return q.get(timeout=0.5)
        except _queue.Empty:
            continue
    return STREAM_END


def feed(batches, q, stop, prep, m: "RunMetrics | None" = None) -> None:
    """A feeder thread's body: put ``prep(b)`` on ``q`` for each batch of
    ``batches``, then STREAM_END.  An exception, its own or the stream's, is
    put on ``q`` for the consumer to raise.  With ``m``, the time spent in
    the stream counts as ``m.decode_s``."""
    try:
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            try:
                b = next(it)
            except StopIteration:
                break
            if m is not None:
                m.decode_s += time.perf_counter() - t0
            if not q_put(q, prep(b), stop):
                return
        q_put(q, STREAM_END, stop)
    except BaseException as e:  # surfaced on the consumer side
        q_put(q, e, stop)


def stage(q, stop):
    """The items of an upstream feeder's queue, as a stream for the next
    feeder: ends at STREAM_END or once ``stop`` is set, raises an upstream
    exception."""
    while True:
        item = q_get(q, stop)
        if item is STREAM_END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def drain(q, stop, threads: list, live: int, step) -> None:
    """The consumer side of a feeder pipeline: start ``threads``, run
    ``step(item)`` on this thread for every item of ``q`` until ``live``
    STREAM_ENDs have come, and raise a feeder's exception here.  On the way
    out, error or not, the feeders are stopped and joined: none is left
    blocked on a full queue holding its decoder open."""
    for t in threads:
        t.start()
    try:
        while live:
            item = q.get()
            if item is STREAM_END:
                live -= 1
                continue
            if isinstance(item, BaseException):
                raise item
            step(item)
    finally:
        stop.set()
        for t in threads:
            t.join()


def join_junctions(ref: CompiledRef, st: "SampleState", junc: tuple | None = None) -> tuple:
    """The host half of a finalize before the statistics: the junction join
    (unless ``junc``, the joined (start_cnt, end_cnt, exact_cnt), is given)
    and directionality, recorded in ``st.metrics``.  Returns (start_cnt,
    end_cnt, exact_cnt, stranded, flip)."""
    m = st.metrics
    sc, ec, xc = junction_counters(ref, st.junc_tally) if junc is None else junc
    stranded, flip, frac, n_inf = detect_directionality(ref, xc)
    m.is_stranded = bool(stranded)
    m.flip_strand = bool(flip)
    m.dir_concordance = float(frac)
    m.dir_informative = int(n_inf)
    return sc, ec, xc, stranded, flip


def result_bundle(ref: CompiledRef, joined: tuple, fc: dict, cache: dict) -> dict:
    """The result bundle of the small counters ``fc``, the join_junctions
    result ``joined`` and the statistics ``cache``."""
    sc, ec, xc, stranded, flip = joined
    fc["start_cnt"], fc["end_cnt"], fc["exact_cnt"] = sc, ec, xc
    args = (ref, None, sc, ec, xc, fc["span_hits"])
    return {
        "counters": fc,
        "rows_nondir": intron_table(*args, mode="nondir", stats_cache=cache),
        "rows_dir": intron_table(*args, mode="dir", flip_strand=flip, stats_cache=cache),
        "stranded": stranded,
        "flip_strand": flip,
    }


def stats_async(ref: CompiledRef, st: "SampleState", depth: torch.Tensor, device: torch.device,
                junc: tuple | None = None):
    """The middle of a finalize, shared by Engine and the mesh: join_junctions
    (overlapping the device work already enqueued), then the per-intron
    statistics launched on ``depth``.  Returns bundle(fc): the result
    bundle of the small counters ``fc``, once the statistics are back."""
    joined = join_junctions(ref, st, junc)
    stats = device_all_stats_async(ref, build_finalize_ref(ref, device), depth, bool(joined[4]))
    return lambda fc: result_bundle(ref, joined, fc, stats())


def pull_concat_async(arrays: list):
    """Start one D2H of every tensor of ``arrays`` (a list of {key:
    tensor}), their bytes concatenated; returns a zero-arg callable yielding
    the same list of {key: numpy array}, each of its tensor's dtype and
    shape."""
    specs = [(i, k, v.dtype, tuple(v.shape)) for i, a in enumerate(arrays) for k, v in a.items()]
    flat = [arrays[i][k].contiguous().reshape(-1).view(torch.uint8) for i, k, _, _ in specs]
    get = pull_async(torch.cat(flat) if flat else torch.empty(0, dtype=torch.uint8))
    sizes = [f.numel() for f in flat]
    n = len(arrays)

    def unpack() -> list:
        buf = get()
        out = [{} for _ in range(n)]
        pos = 0
        for (i, k, dt, shape), size in zip(specs, sizes):
            np_dt = torch.empty(0, dtype=dt).numpy().dtype
            out[i][k] = buf[pos : pos + size].view(np_dt).reshape(shape).copy()
            pos += size
        return out

    return unpack


#: the batched finalize (Engine.results_multi_async) keeps every sample's
#: depth rows on the card at once: over this many bytes of them (2 x N x
#: mbs x 4, the JAX package's guard) the samples finalize one at a time
MULTI_STATS_BUDGET = 2_000_000_000


def ship(fz, device: torch.device, side):
    """One host int32 buffer -> (its copy on ``device``, the copy-done event
    or None).  On a card the buffer is staged in pinned memory and copied on
    the side stream ``side``; the caching host allocator keeps the pinned
    block until that copy completes, so it is never reused too early."""
    if device.type != "cuda":
        return torch.from_numpy(fz), None
    pinned = torch.empty(fz.shape[0], dtype=torch.int32, pin_memory=True)
    pinned.numpy()[:] = fz
    with torch.cuda.device(device), torch.cuda.stream(side):
        flat = pinned.to(device, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    return flat, done


def wait_copy(flat, done, device: torch.device) -> None:
    """Make ``device``'s current stream wait for a ship()ped copy, and keep
    the copy's memory (allocated on the side stream) until that stream has
    read it."""
    if done is not None:
        cur = torch.cuda.current_stream(device)
        cur.wait_event(done)
        flat.record_stream(cur)


class Engine:
    """One reference map on one device; per-sample state in SampleState
    (reset() makes the default one, new_state() one per batch sample).

    ``cap_frags`` is accepted and stored so that the JAX package's call
    sites run unchanged; nothing reads it, since every batch carries its
    own shapes.  ``device`` defaults to the card.  Without one, "cuda" raises:
    counting on the CPU has to be asked for (``device="cpu"``)."""

    def __init__(self, ref: CompiledRef, cap_frags: int = 1 << 15, device="cuda"):
        self.ref = ref
        self.cap_frags = cap_frags
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device (torch.cuda.is_available() is False); "
                "pass device='cpu' to count on the CPU"
            )
        self.dref: DeviceRef = build_device_ref(ref, self.device)
        self._st: SampleState | None = None

    def new_state(self, n_refids: int, counters: dict | None = None) -> SampleState:
        """A sample's state, with zeroed counters unless ``counters`` (on
        this engine's device) are given."""
        dev = str(self.device)
        if self.device.type == "cuda":
            dev += " " + torch.cuda.get_device_name(self.device)
        return SampleState(
            counters=init_counters(self.dref, n_refids) if counters is None else counters,
            metrics=RunMetrics(device=dev),
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
        return ship(b.fused_h2d(), self.device, side)

    def _prep(self, st: SampleState, b: PackedBatch, side) -> tuple:
        """Producer side of one batch: ship it (on ``side``), the time and
        bytes charged to ``st.metrics``.  Returns _count's arguments."""
        t0 = time.perf_counter()
        flat, done = self._ship(b, side)
        st.metrics.wire_bytes += flat.numel() * 4
        st.metrics.h2d_s += time.perf_counter() - t0
        return st, b, flat, done

    def _count(self, st: SampleState, b: PackedBatch, flat, done) -> None:
        """Consumer side of one shipped batch: wait for its copy, run the
        step on the current stream, tally its junctions.  A batch with a
        resume token makes it the sample's: the token then matches the
        counters and the tally."""
        t0 = time.perf_counter()
        wait_copy(flat, done, self.device)
        count_step(self.dref, st.counters, unpack_fused(flat, b.cap_blocks, b.cap_frags))
        st.metrics.device_s += time.perf_counter() - t0
        st.metrics.batches += 1
        if b.resume_token is not None:
            st.resume_token = b.resume_token
        st.junc_tally.add_batch(b)

    def process_batch(self, batch: PackedBatch, st: SampleState | None = None) -> None:
        """Count one batch into ``st`` (default: the engine's own state) on
        the caller's thread, through the stream's code: the fused columns
        shipped on the current stream, one count_step launch, the junctions
        tallied, the batch's resume token taken.  Raises on a batch whose
        columns were never filled.  The launch is not waited for; the
        finalize orders after it."""
        st = st or self._st
        side = torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        self._count(*self._prep(st, batch, side))

    def flush_pending(self) -> None:
        """Nothing to flush: every step is enqueued as its batch is counted
        (the JAX package's deferred step window is not ported).  Kept so
        that its call sites run unchanged."""

    def _sync(self, m: RunMetrics) -> None:
        """End-of-stream device synchronize, charged to ``m``."""
        if self.device.type == "cuda":
            t0 = time.perf_counter()
            torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            m.device_s += dt
            m.sync_s += dt

    def run_stream(self, batches: Iterable[PackedBatch], on_batch=None, skip: int = 0) -> None:
        """Count one sample's batches into the default state: the one-sample
        case of run_multi_stream.  ``skip`` drops that many leading batches
        in the feeder, before any copy to the device (the resume of a
        snapshot without a decoder token)."""
        self.run_multi_stream([(itertools.islice(batches, skip, None), self._st)], on_batch)

    def run_multi_stream(self, streams: "list[tuple]", on_batch=None) -> None:
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

        def prep(st, side):
            return lambda b: self._prep(st, b, side)

        threads = [
            threading.Thread(
                target=feed,
                args=(it_, q, stop, prep(st_, torch.cuda.Stream(self.device) if cuda else None), st_.metrics),
                daemon=True,
            )
            for it_, st_ in streams
        ]
        last = streams[0][1] if streams else None

        def step(item):
            nonlocal last
            last = item[0]
            self._count(*item)
            if on_batch is not None:
                on_batch(item[0], item[1])

        drain(q, stop, threads, len(streams), step)
        if last is not None:
            self._sync(last.metrics)

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
        bundle = stats_async(self.ref, st, fin["depth"], self.device)
        small = {k: pull_async(v.contiguous()) for k, v in fin.items() if k != "depth"}
        m.finalize_s += time.perf_counter() - t0

        def finish() -> dict:
            t1 = time.perf_counter()
            fc = {k: get() for k, get in small.items()}
            fc["depth"] = None  # never pulled: the statistics ran on the card
            out = bundle(fc)
            m.finalize_s += time.perf_counter() - t1
            return out

        return finish

    def results_multi_async(self, sts: "list[SampleState]") -> list:
        """The finalize of N samples that share this engine (batch mode).
        Returns one zero-arg callable per sample, each yielding that
        sample's results_async bundle.

        Batched (N > 1 and 2 x N x mbs x 4 bytes of depth rows within
        MULTI_STATS_BUDGET): every sample's finalize_device, then the host
        junction joins and directionality (so each sample's polarity is
        known), one intron_stats launch over all N depths with one D2H of
        their rows, and one concatenated D2H of every sample's small
        counters, each keeping its dtype.  The launch's seconds are shared
        out evenly over the samples' finalize_s.  Otherwise each callable
        runs its sample's results_async and finish when called: a sample's
        depth rows are made only after the sample before it has finished
        and are dropped when it finishes, so at most one sample's rows are
        on the card.  The tables are the same either way."""
        mbs = int(self.ref.mbs_size)
        if len(sts) <= 1 or 2 * len(sts) * mbs * 4 > MULTI_STATS_BUDGET:
            return [lambda st=st: self.results_async(st)() for st in sts]
        t0 = time.perf_counter()
        fins = [finalize_device(self.dref, st.counters) for st in sts]
        joins = [join_junctions(self.ref, st) for st in sts]
        stats = device_all_stats_multi_async(
            self.ref, build_finalize_ref(self.ref, self.device),
            [f.pop("depth") for f in fins], [1 if j[4] else 0 for j in joins],
        )
        small = pull_concat_async(fins)
        per = (time.perf_counter() - t0) / len(sts)
        for st in sts:
            st.metrics.finalize_s += per
        pulled: dict = {}

        def finish(i: int) -> dict:
            nonlocal stats
            t1 = time.perf_counter()
            if not pulled:
                pulled["stats"], pulled["small"] = stats(), small()
                stats = None  # the depths are no longer needed
            fc = pulled["small"][i]
            fc["depth"] = None  # never pulled: the statistics ran on the card
            out = result_bundle(self.ref, joins[i], fc, pulled["stats"][i])
            sts[i].metrics.finalize_s += time.perf_counter() - t1
            return out

        return [lambda i=i: finish(i) for i in range(len(sts))]

    def counters_host(self, st: SampleState | None = None) -> dict:
        """Every finalized counter as host numpy, the depth included, with
        the junction counters (start_cnt, end_cnt, exact_cnt) joined in from
        the host tally: the JAX package's counters_host.  The host join
        overlaps the pulls; the time counts as ``finalize_s``.

        It pulls the whole depth: 2 x mbs_size x 4 bytes (108 MB at config
        A's map, 2.4 GB at a whole-genome one).  run_bam never calls it:
        its finalize keeps the depth on the card (results_async)."""
        st = st or self._st
        t0 = time.perf_counter()
        fin = finalize_device(self.dref, st.counters)
        pulls = {k: pull_async(v.contiguous()) for k, v in fin.items()}
        sc, ec, xc = junction_counters(self.ref, st.junc_tally)
        # on the CPU a pull is a view of the live counters: copy it
        copy = self.device.type != "cuda"
        out = {k: np.array(get()) if copy else get() for k, get in pulls.items()}
        out["start_cnt"], out["end_cnt"], out["exact_cnt"] = sc, ec, xc
        st.metrics.finalize_s += time.perf_counter() - t0
        return out

    def results(self, fc: dict | None = None, st: SampleState | None = None) -> dict:
        """The result bundle (counters, rows_nondir, rows_dir, stranded,
        flip_strand).  Without ``fc``, the device finalize of ``st``
        (results_async).  With host counters ``fc`` (counters_host's keys),
        directionality on fc["exact_cnt"], recorded in ``st.metrics``, and
        the per-intron statistics of fc["depth"] copied onto this engine's
        device: one intron_stats launch on a card."""
        st = st or self._st
        if fc is None:
            return self.results_async(st)()
        t0 = time.perf_counter()
        depth = depth_on_device(fc["depth"], self.device)
        bundle = stats_async(self.ref, st, depth, self.device,
                             junc=(fc["start_cnt"], fc["end_cnt"], fc["exact_cnt"]))
        out = bundle(dict(fc))
        st.metrics.finalize_s += time.perf_counter() - t0
        return out


def open_decoder(
    ref: CompiledRef,
    bam,
    cap_frags: int = 1 << 15,
    use_native: bool = True,
    n_threads: int = 4,
    resume_token: bytes | None = None,
    long_reads: bool = False,
):
    """Pick the decoder: the multithreaded native C++ decoder for file paths,
    the pure-Python decoder for file objects or when the native toolchain is
    unavailable.  Both emit identical batch streams with every column filled
    (the port ships fused columns, never the TPU wire format) and accept
    each other's resume tokens.  A pipe cannot seek, so only a fresh run
    (no ``resume_token``) takes the native descriptor path."""
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
                    n_threads=n_threads, resume_token=resume_token,
                    blocks_per_frag=bpf, gaps_per_frag=gpf,
                )
            except (RuntimeError, OSError, AssertionError):
                pass  # no toolchain / build failure: fall through to Python
        bam = open(bam, "rb")
    elif use_native and resume_token is None:
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
        bam, chrom_index, cap_frags=cap_frags, resume_token=resume_token,
        blocks_per_frag=bpf, gaps_per_frag=gpf,
    )


#: the snapshot cadence's wall floor: a snapshot waits until this many times
#: the last one's seconds have passed since it ended (SNAPSHOT_MIN_S stands
#: for the cost before the first), so snapshots never take more than about a
#: fifth of a run however fast the batches come
SNAPSHOT_COST_FACTOR = 4.0
SNAPSHOT_MIN_S = 0.1


def snapshot_cadence(path: str, every: int):
    """The consumer-side hook on_batch(st, b) that snapshots ``st`` to
    ``path`` every ``every`` batches of this run, floored by the wall
    interval (SNAPSHOT_COST_FACTOR).  Once the stream has given a decoder
    token, no snapshot is taken after a batch without one (the Python
    decoder's end-of-stream batches): its counters would hold batches that
    the older token would decode again."""
    from .checkpoint import save_checkpoint

    done = 0
    cost = SNAPSHOT_MIN_S
    last = time.perf_counter()

    def on_batch(st: SampleState, b: PackedBatch) -> None:
        nonlocal done, cost, last
        done += 1
        if done % every:
            return
        if b.resume_token is None and st.resume_token is not None:
            return
        if time.perf_counter() - last < SNAPSHOT_COST_FACTOR * cost:
            return
        t0 = time.perf_counter()
        save_checkpoint(path, st)
        last = time.perf_counter()
        cost = max(last - t0, SNAPSHOT_MIN_S)
        st.metrics.checkpoint_s += last - t0
        st.metrics.checkpoints += 1

    return on_batch


def run_bam(
    ref: CompiledRef,
    bam,
    out_dir: str,
    cap_frags: int = 1 << 15,
    use_native: bool = True,
    checkpoint: str | None = None,
    checkpoint_every: int = 64,
    config=None,
    device="cuda",
) -> RunMetrics:
    """The ``-m BAM`` counting path: count one aligner-ordered BAM (path or
    file object) against a compiled reference and write the full output
    table set.  ``config`` (config.RunConfig) overrides the
    keyword knobs when given.  ``device`` is the card unless told otherwise;
    without a card the default raises.

    With ``checkpoint``, a snapshot of the sample's state is written there
    every ``checkpoint_every`` batches, floored by the cadence's wall
    interval (SNAPSHOT_COST_FACTOR), and an existing snapshot is resumed
    from; the snapshot is removed after a successful run (snapshot_cadence
    says when one is taken)."""
    n_threads = 4
    long_reads = False
    if config is not None:
        cap_frags = config.cap_frags
        use_native = config.use_native
        checkpoint = config.checkpoint
        checkpoint_every = config.checkpoint_every
        if config.decoder_threads is not None:
            n_threads = config.decoder_threads
        long_reads = config.long_reads
    engine = Engine(ref, device=device)
    ck = None
    if checkpoint:
        from .checkpoint import load_checkpoint, restore_state

        ck = load_checkpoint(checkpoint)
    token = ck[4] if ck is not None else None
    header, batches, stats = open_decoder(
        ref, bam, cap_frags, use_native, n_threads, resume_token=token, long_reads=long_reads,
    )
    on_batch, skip = None, 0
    if ck is not None:
        engine._st = restore_state(engine, ck)
        if token is None:
            # a snapshot without a decoder token: decode again and skip the
            # batches already counted
            skip = engine.metrics.batches
    else:
        engine.reset(n_refids=len(header.ref_names))
    if checkpoint:
        on_batch = snapshot_cadence(checkpoint, checkpoint_every)
    engine.run_stream(batches, on_batch=on_batch, skip=skip)
    write_run(out_dir, ref, header, stats, engine._st, engine.results_async())
    if checkpoint and os.path.exists(checkpoint):
        os.remove(checkpoint)
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
    consumer; the samples then finalize through Engine.results_multi_async
    (one intron_stats launch for all of them, or one sample at a time past
    MULTI_STATS_BUDGET).  ``multi_stream_s`` and ``multi_finalize_s`` are
    set before the tables and metrics.json are written."""
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
    finishes = engine.results_multi_async([st for _, st, _, _ in streams])
    for (_, st, _, stats), out_dir, finish in zip(streams, out_dirs, finishes):
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "IRFinder-JuncCount.txt"), "w") as fh:
            fmt.write_junc_count(fh, ref.chroms, st.junc_tally)
        results.append(finish())
        st.metrics.reads_total = stats.reads_total
        st.metrics.reads_admitted = stats.reads_admitted
        st.metrics.fragments = stats.fragments
        st.metrics.blocks_inflated = stats.blocks_inflated
    fin_wall = time.perf_counter() - t0

    out_metrics = []
    for (_, st, header, _), out_dir, res in zip(streams, out_dirs, results):
        st.metrics.multi_stream_s = stream_wall
        st.metrics.multi_finalize_s = fin_wall
        write_outputs(out_dir, ref, header, res, st.metrics)
        out_metrics.append(st.metrics)
    return out_metrics


def write_run(out_dir: str, ref: CompiledRef, header: BamHeader, stats, st: SampleState, finish) -> None:
    """One sample's table set, once its stream is counted: the
    stats-independent JuncCount table while the finalize (``finish``, from
    results_async) runs on the device, then the decoder's counts (``stats``)
    into ``st.metrics`` and every other table (write_outputs)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "IRFinder-JuncCount.txt"), "w") as fh:
        fmt.write_junc_count(fh, ref.chroms, st.junc_tally)
    res = finish()
    st.metrics.reads_total = stats.reads_total
    st.metrics.reads_admitted = stats.reads_admitted
    st.metrics.fragments = stats.fragments
    st.metrics.blocks_inflated = stats.blocks_inflated
    write_outputs(out_dir, ref, header, res, st.metrics)


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
