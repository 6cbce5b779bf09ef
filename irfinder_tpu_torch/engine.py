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
and one pull of the small counters for all of them.  Every finalize, of
one sample or many, here or in the mesh, is one composition:
``finalize_async``.

RunMetrics, SampleState, the queue helpers, open_decoder, write_outputs, the
snapshot cadence and run_multi_bam's decoder-thread budget are copied from
irfinder_tpu/engine.py.  The dp x genome mesh (``--mesh``) is
engine_mesh.py; it reuses this module's pipeline pieces (ship, wait_copy,
the feeder and consumer loops feed/stage/drain, snapshot_cadence, the
finalize_async, write_run).

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
from .finalize import detect_directionality, intron_table, junction_counters, junction_tables
from .io.bampy import BamHeader, decode_bam
from .io.batch import PackedBatch, unpack_fused
from .junctions import JuncTally
from .ops.device_ref import DeviceRef, build_device_ref
from .ops.finalize_stats import build_finalize_ref, device_all_stats_multi_async, pull_async
from .ops.step import count_step, depth_on_device, finalize_device, init_counters
from .qc import qc_warnings, write_warnings
from .refio.compile import CompiledRef
from .spans import span


@dataclasses.dataclass
class RunMetrics:
    """Structured run metrics written next to the outputs (SURVEY.md §5.5).
    The count fields and the stage timings carry the JAX package's names;
    its wire-rate fields are left out (the TPU link probe is not ported).
    ``spans`` holds the seconds of every named phase (spans.py); the stage
    timings are the spans of the same name."""

    #: the torch device the run counted on, with the card's name on CUDA
    device: str = ""
    reads_total: int = 0
    reads_admitted: int = 0
    fragments: int = 0
    batches: int = 0
    #: BGZF blocks the native decoder inflated in this run (0 from the
    #: Python decoder): a resume inflates only the blocks after its token
    blocks_inflated: int = 0
    #: records the native decoder's worker pool parsed, and the seconds its
    #: ordering thread (the feeder, inside ``decode``) waited on the pool for
    #: an inflated block or a parsed chunk (0 from the Python decoder)
    decode_pool_records: int = 0
    decode_pool_wait_s: float = 0.0
    decode_s: float = 0.0
    finalize_s: float = 0.0
    #: seconds spent writing snapshots, and how many the cadence wrote
    checkpoint_s: float = 0.0
    checkpoints: int = 0
    #: bytes of fused batch buffers shipped host -> device
    wire_bytes: int = 0
    #: mesh (engine_mesh.py) routed modes: the real fragment rows routed and
    #: the rows the routed cells hold padded (their ratio is the routing's
    #: padding)
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
    #: seconds by span name (spans.py), summed over the sample: open,
    #: stream (stream.wait, count, junctions.tally, checkpoint, sync),
    #: finalize (finalize.device, junctions.merge, junctions.join,
    #: finalize.directionality, finalize.stats_launch, finalize.pull_wait,
    #: finalize.stats_host, finalize.intron_table), write.<table>; on the
    #: feeder threads decode and stage (and route in the mesh).  Batch mode
    #: adds batch (the whole call), batch.finish (from the stream's end to
    #: the return) and within it batch.finalize; these and its stream's
    #: spans are the call's, the same on every sample (batch and
    #: batch.finish close after metrics.json is written)
    spans: dict = dataclasses.field(default_factory=dict)
    #: the sample's index in its run_multi_bam call (None for one sample)
    sample: int | None = None
    #: bytes of the six tables and WARNINGS written
    table_bytes: int = 0
    #: distinct junctions in the sample's tally after its merge
    junctions_distinct: int = 0
    #: raw gap rows the sample's tally took (JuncTally.gap_rows; since the
    #: resume, on a resumed sample): the rows its merge sorts
    junction_rows: int = 0
    #: 1 when this sample's join made the map's key tables
    #: (finalize.junction_tables), 0 when it read them from the map's cache
    junction_tables_made: int = 0
    #: the consumer's queue reads that found no batch waiting (stream.wait)
    stream_waits: int = 0
    #: the samples of the call that counted this one (1 under run_bam)
    batch_samples: int = 1
    #: whether one intron_stats launch took every sample of the call
    #: (results_multi_async's batched branch); False for a sample finalized
    #: alone, past MULTI_STATS_BUDGET or under run_bam
    stats_batched: bool = False
    #: the pool threads this sample's decoder was opened with
    decoder_threads: int = 0

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
    the stream counts as the span ``decode`` (``m.decode_s``)."""
    try:
        it = iter(batches)
        while True:
            with span(m, "decode"):
                b = next(it, STREAM_END)
            if b is STREAM_END:
                break
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


def drain(q, stop, threads: list, live: int, step, ms: list) -> None:
    """The consumer side of a feeder pipeline: start ``threads``, run
    ``step(item)`` on this thread for every item of ``q`` until ``live``
    STREAM_ENDs have come, and raise a feeder's exception here.  A read
    that finds ``q`` empty waits in the span ``stream.wait`` and counts in
    ``stream_waits``, on every RunMetrics of ``ms``.  On the way out, error
    or not, the feeders are stopped and joined: none is left blocked on a
    full queue holding its decoder open."""
    import queue as _queue

    for t in threads:
        t.start()
    try:
        while live:
            try:
                item = q.get_nowait()
            except _queue.Empty:
                for m in ms:
                    m.stream_waits += 1
                with span(ms, "stream.wait"):
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


def tally_join(ref: CompiledRef, st: "SampleState") -> tuple:
    """The sample's junction tally drained (``junctions.merge``) and joined
    against the map (``junctions.join``), its counters recorded in
    ``st.metrics``.  Returns (start_cnt, end_cnt, exact_cnt)."""
    m = st.metrics
    with span(m, "junctions.merge"):  # joins the tally's worker, then folds
        m.junctions_distinct = len(st.junc_tally)
        m.junction_rows = st.junc_tally.gap_rows
    with span(m, "junctions.join"):
        m.junction_tables_made = int(junction_tables(ref)[1])
        return junction_counters(ref, st.junc_tally)


def join_junctions(ref: CompiledRef, st: "SampleState", junc: tuple | None = None) -> tuple:
    """The host half of a finalize before the statistics: the junction join
    (unless ``junc``, the joined (start_cnt, end_cnt, exact_cnt), is given)
    and directionality, recorded in ``st.metrics``.  Returns (start_cnt,
    end_cnt, exact_cnt, stranded, flip)."""
    m = st.metrics
    sc, ec, xc = tally_join(ref, st) if junc is None else junc
    with span(m, "finalize.directionality"):
        stranded, flip, frac, n_inf = detect_directionality(ref, xc)
    m.is_stranded = bool(stranded)
    m.flip_strand = bool(flip)
    m.dir_concordance = float(frac)
    m.dir_informative = int(n_inf)
    return sc, ec, xc, stranded, flip


def result_bundle(ref: CompiledRef, joined: tuple, fc: dict, cache: dict) -> dict:
    """The result bundle of the small counters ``fc``, the join_junctions
    result ``joined`` and the statistics ``cache``: the IR tables' rows
    (its callers time it as the span ``finalize.intron_table``)."""
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


def finalize_async(ref: CompiledRef, device: torch.device, sts: "list[SampleState]", device_half,
                   juncs: list | None = None) -> list:
    """The finalize of k >= 1 samples that share ``ref`` and ``device``, for
    every caller: Engine's one sample (results_async, results(fc)), batch
    mode's samples (results_multi_async) and the mesh's sample.

    ``device_half()`` enqueues the samples' device work (in the caller's
    span ``finalize.device``) and returns (depths, small): each sample's
    (2, mbs) int32 depth on ``device`` in depth_rows' layout, and a zero-arg
    callable yielding a list of each sample's small host counters.  Then
    join_junctions of each sample (``juncs[i]``, when given, its joined
    (start_cnt, end_cnt, exact_cnt)), overlapping the device work, and one
    device_all_stats_multi_async over the k depths with their polarities:
    one intron_stats launch and one D2H of the rows
    (``finalize.stats_launch``).  All of this is the span ``finalize``, its
    seconds shared out evenly over the samples (for k = 1, the whole).

    Returns k zero-arg callables, the i-th yielding sample i's result
    bundle in its own span ``finalize``.  The first one called calls
    ``small()`` (``finalize.pull_wait``: the wait for the small counters;
    where a pull was started, its start is in ``finalize.device``), waits
    for the rows and finishes every sample's statistics
    (``finalize.stats_host``); each builds its bundle
    (``finalize.intron_table``).  A counter dict without "depth" gets None:
    the depth never left the card."""
    ms = [st.metrics for st in sts]
    with span(ms, "finalize", split=True):
        depths, small = device_half()
        joins = [join_junctions(ref, st, j) for st, j in zip(sts, juncs or [None] * len(sts))]
        with span(ms, "finalize.stats_launch", split=True):
            stats = device_all_stats_multi_async(
                ref, build_finalize_ref(ref, device), depths, [1 if j[4] else 0 for j in joins],
            )
    pulled: dict = {}

    def finish(i: int) -> dict:
        nonlocal stats
        m = ms[i]
        with span(m, "finalize"):
            if not pulled:
                with span(m, "finalize.pull_wait"):
                    pulled["small"] = small()
                with span(m, "finalize.stats_host"):
                    pulled["stats"] = stats()
                stats = None  # the depths are no longer needed
            fc = pulled["small"][i]
            fc.setdefault("depth", None)
            with span(m, "finalize.intron_table"):
                return result_bundle(ref, joins[i], fc, pulled["stats"][i])

    return [lambda i=i: finish(i) for i in range(len(sts))]


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
        """Producer side of one batch: ship it (on ``side``) in the span
        ``stage``, the bytes charged to ``st.metrics``.  Returns _count's
        arguments."""
        with span(st.metrics, "stage"):
            flat, done = self._ship(b, side)
        st.metrics.wire_bytes += flat.numel() * 4
        return st, b, flat, done

    def _count(self, st: SampleState, b: PackedBatch, flat, done) -> None:
        """Consumer side of one shipped batch: wait for its copy and enqueue
        the step on the current stream (the span ``count``), tally its
        junctions (``junctions.tally``).  A batch with a resume token makes
        it the sample's: the token then matches the counters and the
        tally."""
        m = st.metrics
        with span(m, "count"):
            wait_copy(flat, done, self.device)
            count_step(self.dref, st.counters, unpack_fused(flat, b.cap_blocks, b.cap_frags))
        m.batches += 1
        if b.resume_token is not None:
            st.resume_token = b.resume_token
        with span(m, "junctions.tally"):
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

    def _sync(self, ms: list) -> None:
        """End-of-stream device synchronize, the span ``sync`` of every
        RunMetrics of ``ms``."""
        if self.device.type == "cuda":
            with span(ms, "sync"):
                torch.cuda.synchronize(self.device)

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
        overlap, so the sum can exceed the wall).  The pipeline is the
        span ``stream``; it, the consumer's waits (``stream.wait``) and the
        one end-of-stream synchronize (``sync``) are the call's, recorded
        on every sample.  A batch's ``count`` and ``junctions.tally`` are
        its own sample's."""
        import queue
        import threading

        ms = [st_.metrics for _, st_ in streams]
        with span(ms, "stream"):
            q: "queue.Queue" = queue.Queue(maxsize=max(4, 2 * len(streams)))
            stop = threading.Event()
            cuda = self.device.type == "cuda"

            def prep(st, side):
                return lambda b: self._prep(st, b, side)

            threads = [
                threading.Thread(
                    target=feed,
                    args=(it_, q, stop, prep(st_, torch.cuda.Stream(self.device) if cuda else None),
                          st_.metrics),
                    daemon=True,
                )
                for it_, st_ in streams
            ]

            def step(item):
                self._count(*item)
                if on_batch is not None:
                    on_batch(item[0], item[1])

            drain(q, stop, threads, len(streams), step, ms)
            self._sync(ms)

    def results_async(self, st: SampleState | None = None):
        """Launch the device finalize of ``st`` without blocking and return
        a zero-arg callable that waits for the pulls and builds the result
        bundle: finalize_async of the one sample (_finalize_async)."""
        return self._finalize_async([st or self._st])[0]

    def _finalize_async(self, sts: "list[SampleState]") -> list:
        """finalize_async of samples counted on this engine: each sample's
        finalize_device (its span ``finalize.device``), then one
        concatenated D2H of every sample's small counters, each keeping its
        dtype (``finalize.device``, shared out over the samples).  Only the
        packed stats rows and the small counters come back; the depth stays
        on the card (``counters["depth"]`` is None)."""

        def device_half():
            fins = []
            for st in sts:
                with span(st.metrics, "finalize.device"):
                    fins.append(finalize_device(self.dref, st.counters))
            depths = [f.pop("depth") for f in fins]
            with span([st.metrics for st in sts], "finalize.device", split=True):
                return depths, pull_concat_async(fins)

        return finalize_async(self.ref, self.device, sts, device_half)

    def results_multi_async(self, sts: "list[SampleState]") -> list:
        """The finalize of N samples that share this engine (batch mode).
        Returns one zero-arg callable per sample, each yielding that
        sample's results_async bundle.

        Batched (N > 1 and 2 x N x mbs x 4 bytes of depth rows within
        MULTI_STATS_BUDGET): one finalize_async of all N samples (one
        intron_stats launch, one pull of the small counters), which sets
        every sample's ``stats_batched``.  Otherwise each callable runs its
        sample's results_async and finish when called: a sample's depth
        rows are made only after the sample before it has finished and are
        dropped when it finishes, so at most one sample's rows are on the
        card.  The tables are the same either way."""
        mbs = int(self.ref.mbs_size)
        if len(sts) <= 1 or 2 * len(sts) * mbs * 4 > MULTI_STATS_BUDGET:
            return [lambda st=st: self.results_async(st)() for st in sts]
        for st in sts:
            st.metrics.stats_batched = True
        return self._finalize_async(sts)

    def counters_host(self, st: SampleState | None = None) -> dict:
        """Every finalized counter as host numpy, the depth included, with
        the junction counters (start_cnt, end_cnt, exact_cnt) joined in from
        the host tally: the JAX package's counters_host.  The host join
        overlaps the pulls; the time counts as ``finalize_s``.

        It pulls the whole depth: 2 x mbs_size x 4 bytes (108 MB at config
        A's map, 2.4 GB at a whole-genome one).  run_bam never calls it:
        its finalize keeps the depth on the card (results_async)."""
        st = st or self._st
        m = st.metrics
        with span(m, "finalize"):
            with span(m, "finalize.device"):
                fin = finalize_device(self.dref, st.counters)
                pulls = {k: pull_async(v.contiguous()) for k, v in fin.items()}
            sc, ec, xc = tally_join(self.ref, st)
            # on the CPU a pull is a view of the live counters: copy it
            copy = self.device.type != "cuda"
            with span(m, "finalize.pull_wait"):
                out = {k: np.array(get()) if copy else get() for k, get in pulls.items()}
        out["start_cnt"], out["end_cnt"], out["exact_cnt"] = sc, ec, xc
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

        def device_half():
            with span(st.metrics, "finalize.device"):
                return [depth_on_device(fc["depth"], self.device)], lambda: [dict(fc)]

        junc = (fc["start_cnt"], fc["end_cnt"], fc["exact_cnt"])
        return finalize_async(self.ref, self.device, [st], device_half, [junc])[0]()


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
        with span(st.metrics, "checkpoint") as sp:
            save_checkpoint(path, st)
        last = time.perf_counter()
        cost = max(sp.s, SNAPSHOT_MIN_S)
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
    says when one is taken).

    The phases are the spans open (the engine and its device reference, the
    decoder, the sample's state), stream, finalize and write.<table>;
    ``decoder_threads`` records the decoder's pool."""
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
    opened: list = []  # the sample's RunMetrics, once its state is made
    with span(opened, "open"):
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
                # a snapshot without a decoder token: decode again and skip
                # the batches already counted
                skip = engine.metrics.batches
        else:
            engine.reset(n_refids=len(header.ref_names))
        engine.metrics.decoder_threads = n_threads
        opened.append(engine.metrics)
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
    (one intron_stats launch for all of them, ``stats_batched``, or one
    sample at a time past MULTI_STATS_BUDGET).  Every sample records
    ``batch_samples`` (N) and ``decoder_threads`` (its decoder's pool).

    The spans: ``batch``, the whole call, and within it ``open`` (the
    engine and every decoder and state), ``stream`` and ``batch.finish``,
    from the stream's end to the return: ``batch.finalize`` (the finalize
    and the JuncCount table of every sample, in turn), then every sample's
    other tables and metrics.json, in turn.  ``open`` is shared out evenly
    over the samples; the others carry the call's seconds on every sample.
    ``multi_stream_s`` and ``multi_finalize_s`` (``stream`` and
    ``batch.finalize``) are set before the tables and metrics.json are
    written; ``batch`` and ``batch.finish`` close after them, so each
    sample's metrics.json leaves those two out and only the returned
    RunMetrics hold them."""
    if len(bams) != len(out_dirs):
        raise ValueError("bams and out_dirs must pair up")
    # global decoder-thread budget: ~2 inflate threads per vCPU across ALL
    # samples; feeder threads mostly block in the decoder and do not count
    # against it
    n_threads = max(1, (2 * (os.cpu_count() or 4)) // max(1, len(bams)))
    ms: list = []
    streams = []
    with span(ms, "batch"):
        with span(ms, "open", split=True):
            engine = Engine(ref, device=device)
            for i, path in enumerate(bams):
                header, batches, stats = open_decoder(ref, path, cap_frags, use_native, n_threads)
                st = engine.new_state(n_refids=len(header.ref_names))
                st.metrics.sample = i
                st.metrics.batch_samples = len(bams)
                st.metrics.decoder_threads = n_threads
                streams.append((batches, st, header, stats))
                ms.append(st.metrics)

        engine.run_multi_stream([(it_, st) for it_, st, _, _ in streams])

        with span(ms, "batch.finish"):
            results = []
            with span(ms, "batch.finalize") as drained:
                finishes = engine.results_multi_async([st for _, st, _, _ in streams])
                for (_, st, _, stats), out_dir, finish in zip(streams, out_dirs, finishes):
                    results.append(write_first(out_dir, ref, stats, st, finish))

            for (_, st, header, _), out_dir, res in zip(streams, out_dirs, results):
                st.metrics.multi_stream_s = st.metrics.spans["stream"]
                st.metrics.multi_finalize_s = drained.s
                write_outputs(out_dir, ref, header, res, st.metrics)
    return ms


def write_table(out_dir: str, name: str, m: RunMetrics, render) -> None:
    """Write ``out_dir/name`` (making ``out_dir``) with ``render(fh)`` in the
    span ``write.<name>`` (less ``IRFinder-`` and ``.txt``); its bytes count
    in ``m.table_bytes``."""
    path = os.path.join(out_dir, name)
    with span(m, "write." + name.removeprefix("IRFinder-").removesuffix(".txt")):
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as fh:
            render(fh)
    m.table_bytes += os.path.getsize(path)


def write_first(out_dir: str, ref: CompiledRef, stats, st: SampleState, finish) -> dict:
    """The part of a sample's table set that the finalize overlaps: the
    stats-independent JuncCount table while the finalize (``finish``, from
    results_async) runs on the device; then the finish and the decoder's
    counts (``stats``) into ``st.metrics``.  Returns the result bundle."""
    write_table(out_dir, "IRFinder-JuncCount.txt", st.metrics,
                lambda fh: fmt.write_junc_count(fh, ref.chroms, st.junc_tally))
    res = finish()
    st.metrics.reads_total = stats.reads_total
    st.metrics.reads_admitted = stats.reads_admitted
    st.metrics.fragments = stats.fragments
    st.metrics.blocks_inflated = stats.blocks_inflated
    st.metrics.decode_pool_records = stats.pool_records
    st.metrics.decode_pool_wait_s = stats.pool_wait_s
    return res


def write_run(out_dir: str, ref: CompiledRef, header: BamHeader, stats, st: SampleState, finish) -> None:
    """One sample's table set, once its stream is counted: write_first, then
    every other table (write_outputs)."""
    res = write_first(out_dir, ref, stats, st, finish)
    write_outputs(out_dir, ref, header, res, st.metrics)


def write_metrics(out_dir: str, m: RunMetrics) -> None:
    """metrics.json, in the span ``write.metrics`` (which the file, written
    inside it, cannot hold; the returned RunMetrics does)."""
    with span(m, "write.metrics"):
        with open(os.path.join(out_dir, "metrics.json"), "w") as fh:
            json.dump(m.as_dict(), fh, indent=1)


def write_outputs(
    out_dir: str, ref: CompiledRef, header: BamHeader, res: dict, metrics: RunMetrics
) -> None:
    """Every table but IRFinder-JuncCount.txt (run_bam writes that one while
    the finalize runs), WARNINGS and metrics.json."""
    fc = res["counters"]
    for name, render in (
        ("IRFinder-IR-nondir.txt", lambda fh: fmt.write_ir_table(fh, res["rows_nondir"])),
        ("IRFinder-IR-dir.txt", lambda fh: fmt.write_ir_table(fh, res["rows_dir"])),
        ("IRFinder-SpansPoint.txt", lambda fh: fmt.write_spans_point(fh, ref, fc["span_hits"])),
        ("IRFinder-ROI.txt", lambda fh: fmt.write_roi(fh, ref, fc["roi_cnt"])),
        ("IRFinder-ChrCoverage.txt", lambda fh: fmt.write_chr_coverage(fh, header.ref_names, fc["chr_frag"])),
        ("WARNINGS", lambda fh: write_warnings(fh, qc_warnings(ref, fc, metrics))),
    ):
        write_table(out_dir, name, metrics, render)
    write_metrics(out_dir, metrics)
