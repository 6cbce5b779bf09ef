"""The dp x genome mesh (``--mesh``): port of irfinder_tpu/engine_mesh.py.

    decode -> [pad / route] -> one count step per mesh cell
           -> integer merge over dp -> reassemble over genome -> finalize
           -> the full output table set, byte-identical to engine.run_bam.

A mesh is one process over an explicit list of torch devices, one per cell
(dp, genome) in row-major order; cells may share a card.  It is the
counterpart of the JAX package's single-controller Mesh("dp", "genome"):

* dp=N              the read stream split over N cells, the map replicated.
* dp=N, genome=G    the map split over G chromosome-range shards
                    (parallel/genome.py), each dp chunk of a batch
                    replicated to every shard of its row.
* ... routed        the host partitions each batch by owning chromosome
                    (route_flat_batch), so every cell counts only its own
                    shard's reads.

Every cell holds its shard's DeviceRef (padded to the plan's uniform sizes),
its own counters and, on a card, its own side stream for the copies.  Per
batch, each cell's columns are fused into one buffer, shipped to its device
and counted there by ops/step.count_step: one launch of csrc/count.cu per
cell.  The finalize sums each shard's counters over dp, reassembles the
small sections on the host and the depth on the first cell's device (one
row buffer laid out as the unsharded depth), where kernels.intron_stats
reads it in one launch.  Counters are integers, so the tables are
byte-identical at any (dp, genome).

``dp == 1, genome > 1`` with fewer devices than shards runs the unsharded
Engine: the port counts whole-genome maps on one card as they are, so it
has no counterpart of the JAX package's binned form.  Not ported either:
the binned and wire steps, auto_genome_bins, the deferred window, the link
probe and the finalize prewarm (TPU transfer workarounds).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable

import numpy as np
import torch

from .config import RunConfig
from .engine import (
    RunMetrics, SampleState, drain, feed, finalize_async, open_decoder, run_bam, ship,
    snapshot_cadence, stage, wait_copy, write_metrics, write_run,
)
from .io.batch import BLOCKS_PER_FRAG, PackedBatch, unpack_fused
from .ops.device_ref import from_columns
from .ops.step import count_step, init_counters
from .parallel.genome import (
    make_depth_reassemble, merge_dp, plan_shards, reassemble_counters, route_flat_batch,
    shard_columns,
)
from .parallel.shard import fused_cells, on_device, pad_batch_to_multiple
from .refio.compile import CompiledRef
from .spans import span


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Parsed --mesh flag: dp=N,genome=G[,routed]."""

    dp: int = 1
    genome: int = 1
    routed: bool = False

    @staticmethod
    def parse(s: str) -> "MeshSpec":
        dp, genome, routed = 1, 1, False
        for part in s.split(","):
            part = part.strip()
            if not part:
                continue
            if part == "routed":
                routed = True
            elif part.startswith("dp="):
                dp = int(part[3:])
            elif part.startswith("genome="):
                genome = int(part[7:])
            else:
                raise ValueError(
                    f"bad --mesh component {part!r} (want dp=N,genome=G[,routed])"
                )
        if dp < 1 or genome < 1:
            raise ValueError("--mesh axes must be >= 1")
        return MeshSpec(dp=dp, genome=genome, routed=routed)

    @property
    def n_devices(self) -> int:
        return self.dp * self.genome

    def __str__(self) -> str:
        return f"dp={self.dp},genome={self.genome}" + (",routed" if self.routed else "")


def mesh_devices(spec: MeshSpec, devices=None, device="cuda") -> list:
    """The torch devices of the mesh's cells, row-major over (dp, genome).

    ``devices``, when given, is the list itself: exactly spec.n_devices
    entries, which may repeat one card.  Otherwise ``device`` decides:
    "cuda" takes cuda:0 ... cuda:n-1 (as many cards as there are, up to n),
    a card with an index ("cuda:1") or "cpu" is repeated n times.  Returns
    fewer than n devices only for dp == 1, genome > 1: the caller then runs
    the unsharded Engine on the first.  Any other shortfall raises
    ValueError; a card asked for where there is none raises RuntimeError."""
    n = spec.n_devices
    if devices is None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
            devices = [torch.device("cuda", i) for i in range(min(n, torch.cuda.device_count()))]
        else:
            devices = [dev] * n
    devices = [torch.device(d) for d in devices]
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device (torch.cuda.is_available() is False); "
            "pass device='cpu' to count on the CPU"
        )
    if len(devices) == n or (devices and len(devices) < n and spec.dp == 1 and spec.genome > 1):
        return devices
    raise ValueError(f"mesh {spec} needs {n} devices, have {len(devices)}")


@dataclasses.dataclass
class Cell:
    """One (dp, genome) member of the mesh."""

    dp: int
    g: int
    device: torch.device
    dref: object  # its genome shard's DeviceRef, on its device
    side: object  # its side stream for the copies (None on the CPU)


class MeshEngine:
    """One genome-sharded reference over a mesh of cells; per-sample state in
    engine.SampleState, its counters {"cnt", "chr"} each a nested
    [dp][genome] list of the cells' tensors.

    ``devices`` must hold exactly spec.n_devices torch devices (see
    mesh_devices), one per cell, row-major over (dp, genome)."""

    def __init__(self, ref: CompiledRef, spec: MeshSpec, devices: list, cap_frags: int = 1 << 15):
        devices = [torch.device(d) for d in devices]
        if len(devices) != spec.n_devices:
            raise ValueError(f"mesh {spec} needs {spec.n_devices} devices, have {len(devices)}")
        if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (torch.cuda.is_available() is False)")
        self.ref = ref
        self.spec = spec
        self.routed = spec.routed
        self.plan = plan_shards(ref, spec.genome)
        cols = shard_columns(ref, self.plan)
        drefs: dict = {}  # (device, shard) -> DeviceRef: cells on one card share it
        self.cells = []
        for i in range(spec.dp):
            row = []
            for g in range(spec.genome):
                dev = devices[i * spec.genome + g]
                if (dev, g) not in drefs:
                    with on_device(dev):
                        drefs[dev, g] = from_columns(cols[g], dev)
                side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
                row.append(Cell(i, g, dev, drefs[dev, g], side))
            self.cells.append(row)
        #: the finalize's device: the first cell's
        self.device = devices[0]
        self._depth_fn = make_depth_reassemble(self.plan)
        # monotonic cell-cap floors for the routed cells, from half the
        # uniform per-cell share, so that the cell buffers take few sizes
        denom = spec.dp * spec.genome
        self._min_caps = [
            max(128, (cap_frags * BLOCKS_PER_FRAG) // (2 * denom)),
            max(128, cap_frags // (2 * denom)),
        ]

    def _flat_cells(self) -> list:
        return [c for row in self.cells for c in row]

    def _describe(self) -> str:
        devs = []
        for c in self._flat_cells():
            name = str(c.device)
            if c.device.type == "cuda":
                name += f" ({torch.cuda.get_device_name(c.device)})"
            if name not in devs:
                devs.append(name)
        return f"mesh {self.spec}: {self.spec.n_devices} cells on {', '.join(devs)}"

    # -- lifecycle ------------------------------------------------------------
    def new_state(self, n_refids: int) -> SampleState:
        """A sample's state, with zeroed counters in every cell."""
        cnt, chrn = [], []
        for row in self.cells:
            z = [init_counters(c.dref, n_refids) for c in row]
            cnt.append([x["cnt"] for x in z])
            chrn.append([x["chr"] for x in z])
        return SampleState(counters={"cnt": cnt, "chr": chrn}, metrics=RunMetrics(device=self._describe()))

    def restore_state(self, ckpt) -> SampleState:
        """checkpoint.load_checkpoint tuple -> SampleState with the stacked
        (dp, genome, ...) counters placed back in their cells.  A snapshot
        resumes only under the --mesh shape and reference it was written
        under: the stacked shapes encode them."""
        (cnt, chrn), tally, batches_done, n_refids = ckpt[:4]
        token = ckpt[4] if len(ckpt) > 4 else None
        lead = (self.spec.dp, self.spec.genome)
        want = {"cnt": lead + (self.plan.layout.total,), "chr": lead + (n_refids + 1,)}
        got = {"cnt": tuple(cnt.shape), "chr": tuple(chrn.shape)}
        if want != got:
            raise ValueError(
                f"mesh checkpoint shape mismatch (snapshot written under a "
                f"different --mesh or reference?): {got} vs {want}"
            )
        st = self.new_state(n_refids)
        for k, v in (("cnt", cnt), ("chr", chrn)):
            for c in self._flat_cells():
                st.counters[k][c.dp][c.g].copy_(torch.from_numpy(np.ascontiguousarray(v[c.dp, c.g], np.int32)))
        st.junc_tally = tally
        st.metrics.batches = batches_done
        st.resume_token = token
        return st

    # -- accumulation ----------------------------------------------------------
    def prep_batch(self, b: PackedBatch, m: RunMetrics | None = None) -> tuple:
        """Host side of one batch, on the feeder thread: pad to the dp split,
        route by owning chromosome (routed modes), fuse each cell's columns
        into one buffer and ship it to the cell's device on the cell's side
        stream.  A replicated dp chunk is shipped once per device it goes
        to.  Returns (per-cell (buffer, copy-done event) in row-major order,
        cap_blocks, cap_frags); ``m`` gets the spans ``route`` and ``stage``,
        the routed padding and the bytes shipped."""
        if not b.columns_full:
            raise RuntimeError(
                "wire-only decoder batch (columns_full=False): its block/frag "
                "columns were never filled"
            )
        dp, G = self.spec.dp, self.spec.genome
        arrays = pad_batch_to_multiple(b.device_arrays(), dp)
        if self.routed:
            with span(m, "route"):
                arrays, _ = route_flat_batch(self.plan, arrays, dp, G, min_caps=tuple(self._min_caps))
                self._min_caps[0] = max(self._min_caps[0], len(arrays["blk_chrom"]) // (dp * G))
                self._min_caps[1] = max(self._min_caps[1], len(arrays["frag_chrom"]) // (dp * G))
                rows, cb, cf = fused_cells(arrays, dp * G)
            if m is not None:
                m.route_rows_real += int(b.n_frags)
                m.route_rows_padded += int(arrays["frag_chrom"].size)
        else:
            rows, cb, cf = fused_cells(arrays, dp)
        shipped, out = {}, []
        with span(m, "stage"):
            for c in self._flat_cells():
                r = c.dp * G + c.g if self.routed else c.dp
                if (c.device, r) not in shipped:
                    shipped[c.device, r] = ship(rows[r], c.device, c.side)
                    if m is not None:
                        m.wire_bytes += rows[r].nbytes
                out.append(shipped[c.device, r])
        return out, cb, cf

    def _count(self, st: SampleState, b: PackedBatch, placed: tuple) -> None:
        """Consumer side of one prepared batch: each cell waits for its copy
        and counts its columns on its device's current stream (the span
        ``count``); then the batch's junctions are tallied on the host
        (``junctions.tally``)."""
        m = st.metrics
        bufs, cb, cf = placed
        with span(m, "count"):
            for c, (flat, done) in zip(self._flat_cells(), bufs):
                with on_device(c.device):
                    wait_copy(flat, done, c.device)
                    counters = {"cnt": st.counters["cnt"][c.dp][c.g], "chr": st.counters["chr"][c.dp][c.g]}
                    count_step(c.dref, counters, unpack_fused(flat, cb, cf))
        m.batches += 1
        if b.resume_token is not None:
            st.resume_token = b.resume_token
        with span(m, "junctions.tally"):
            st.junc_tally.add_batch(b)

    def process_batch(self, b: PackedBatch, st: SampleState) -> None:
        """One batch through every cell, on the caller's thread."""
        self._count(st, b, self.prep_batch(b, st.metrics))

    def flush_pending(self) -> None:
        """Nothing to flush: every cell's step is enqueued as its batch is
        counted (the JAX package's deferred step window is not ported).
        Kept so that its call sites run unchanged."""

    def _sync(self, m: RunMetrics) -> None:
        """End-of-stream synchronize of every card, the span ``sync``."""
        with span(m, "sync"):
            for dev in {c.device for c in self._flat_cells() if c.device.type == "cuda"}:
                torch.cuda.synchronize(dev)

    def run_stream(self, batches: Iterable[PackedBatch], st: SampleState, on_batch=None) -> None:
        """Count a batch stream into ``st``: a decode feeder thread, a
        route-and-ship feeder thread, and this thread launching every cell's
        step and tallying the junctions (as irfinder_tpu/engine_mesh.py
        splits it).  ``on_batch(st, b)`` runs here after each batch's steps
        are enqueued in every cell (the snapshot cadence).  The whole is the
        span ``stream``."""
        import queue
        import threading

        q1: "queue.Queue" = queue.Queue(maxsize=2)  # decode -> route/ship
        q2: "queue.Queue" = queue.Queue(maxsize=2)  # route/ship -> consumer
        stop = threading.Event()
        m = st.metrics
        threads = [
            threading.Thread(target=feed, args=(batches, q1, stop, lambda b: b, m), daemon=True),
            threading.Thread(
                target=feed, args=(stage(q1, stop), q2, stop, lambda b: (b, self.prep_batch(b, m))), daemon=True
            ),
        ]

        def step(item):
            b, placed = item
            self._count(st, b, placed)
            if on_batch is not None:
                on_batch(st, b)

        with span(m, "stream"):
            drain(q2, stop, threads, 1, step, [m])
            self._sync(m)

    # -- finalize ---------------------------------------------------------------
    def merged_shards(self, st: SampleState) -> list:
        """Each genome shard's counters summed over dp (parallel/genome.py
        merge_dp), on the device of the shard's dp-0 cell."""
        return merge_dp([
            [{"cnt": st.counters["cnt"][i][g], "chr": st.counters["chr"][i][g]} for g in range(self.spec.genome)]
            for i in range(self.spec.dp)
        ])

    def depth(self, per_shard: list) -> torch.Tensor:
        """The global (2, mbs) depth of merged counters, reassembled on the
        finalize device in the layout kernels.intron_stats reads."""
        with on_device(self.device):
            return self._depth_fn([s["cnt"] for s in per_shard], self.device)

    def results_async(self, st: SampleState):
        """Launch the device finalize without blocking and return a zero-arg
        callable that builds the result bundle: engine.finalize_async of the
        one sample on the finalize device.

        The depth is reassembled on the finalize device; the host junction
        join overlaps the reassembly.  The small sections are reassembled on
        the host when the bundle is asked for (reassemble_counters, the span
        ``finalize.pull_wait``: it pulls them); the depth never leaves the
        card."""

        def device_half():
            with span(st.metrics, "finalize.device"):
                per_shard = self.merged_shards(st)
                depth = self.depth(per_shard)
            return [depth], lambda: [reassemble_counters(
                self.ref, self.plan,
                {"cnt": [s["cnt"] for s in per_shard], "chr": [s["chr"] for s in per_shard]},
                per_shard[0]["chr"].shape[-1] - 1, routed=self.routed, with_depth=False,
            )]

        with on_device(self.device):
            return finalize_async(self.ref, self.device, [st], device_half)[0]

    def results(self, st: SampleState) -> dict:
        return self.results_async(st)()


def run_bam_mesh(
    ref: CompiledRef,
    bam,
    out_dir: str,
    spec: MeshSpec,
    devices=None,
    cap_frags: int = 1 << 15,
    use_native: bool = True,
    n_threads: int = 4,
    checkpoint: str | None = None,
    checkpoint_every: int = 64,
    long_reads: bool = False,
    config=None,
    device="cuda",
) -> RunMetrics:
    """``-m BAM --mesh ...``: count one aligner-ordered BAM over a mesh and
    write the full output table set (byte-identical to the unsharded
    run_bam).  ``config`` (config.RunConfig) overrides the keyword knobs.
    ``devices`` and ``device`` pick the cells' devices (mesh_devices); with
    dp == 1 and fewer devices than genome shards the unsharded Engine runs
    on the first, and ``metrics.device`` says so.

    Checkpointing follows run_bam (the same cadence, token-based seek
    resume).  A snapshot holds the stacked mesh counters, so it resumes only
    under the same --mesh shape, and only a snapshot with a decoder token
    resumes: a mesh never decodes a prefix again to skip it."""
    if config is None:
        config = RunConfig(
            cap_frags=cap_frags, use_native=use_native, decoder_threads=n_threads,
            checkpoint=checkpoint, checkpoint_every=checkpoint_every, long_reads=long_reads,
        )
    devices = mesh_devices(spec, devices, device)
    if len(devices) < spec.n_devices:
        m = run_bam(ref, bam, out_dir, config=config, device=devices[0])
        m.device = (f"unsharded Engine on {m.device}: mesh {spec} has {len(devices)} "
                    f"device(s) for {spec.genome} genome shards")
        write_metrics(out_dir, m)
        return m
    n_threads = config.decoder_threads if config.decoder_threads is not None else 4
    opened: list = []  # the sample's RunMetrics, once its state is made
    with span(opened, "open"):
        eng = MeshEngine(ref, spec, devices, cap_frags=config.cap_frags)
        ck = None
        if config.checkpoint:
            from .checkpoint import load_checkpoint

            ck = load_checkpoint(config.checkpoint)
            if ck is not None and ck[4] is None:
                raise ValueError(
                    "mesh runs resume only from token-carrying snapshots "
                    "(a re-decode skip is an unsharded-engine path)"
                )
        header, batches, stats = open_decoder(
            ref, bam, config.cap_frags, config.use_native, n_threads,
            resume_token=ck[4] if ck is not None else None, long_reads=config.long_reads,
        )
        st = eng.restore_state(ck) if ck is not None else eng.new_state(n_refids=len(header.ref_names))
        opened.append(st.metrics)
    on_batch = snapshot_cadence(config.checkpoint, config.checkpoint_every) if config.checkpoint else None
    eng.run_stream(batches, st, on_batch=on_batch)
    write_run(out_dir, ref, header, stats, st, eng.results_async(st))
    if config.checkpoint and os.path.exists(config.checkpoint):
        os.remove(config.checkpoint)
    return st.metrics
