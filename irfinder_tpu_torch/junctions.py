"""Sparse splice-junction tally, fully vectorized.

The one counter that stays on the host (ops/step.py docstring): observed
splice junctions have sparse dynamic (chrom, start, end) keys that do not map
to dense device scatter targets, so the engine tallies them host-side.  The
reference incremented a std::map per gap (SURVEY.md §2 row 10, historical
src/irfinder/ReadBlockProcessor.cpp [R]); the first TPU build used a Python
dict with a per-unique-key loop per batch, which became the bottleneck on
realistic spliced-read mixes (~25-35% of RNA-seq reads carry N CIGAR ops).

This accumulator never touches a Python-level loop on the hot path: each
batch packs its (chrom, start, end, strand) gap columns into two int64 key
arrays (O(n) arithmetic, no sort), and pending chunks are compacted by a
two-key lexsort + reduceat whenever their row total crosses a threshold —
amortized O(n log n) overall, bounded memory.

Key packing (lexicographic order preserved):
    k1 = chrom << 32 | start      (chrom < 2^16, start < 2^31)
    k2 = end << 1 | strand        (strand is the least-significant sort key
                                   so same-junction rows stay adjacent)
"""

from __future__ import annotations

import threading

import numpy as np

#: Hand pending chunks to the background compaction worker at this many raw
#: rows.  Compactions (2-key lexsort + reduceat over the pending rows) run on
#: a daemon thread so they ride idle host cycles during streaming instead of
#: landing as one multi-second sort on the finalize critical path (measured
#: 2.7 s for 3.2M gap rows at the 10M-read point on the 2-vCPU dev box);
#: np.lexsort releases the GIL, so the worker genuinely overlaps the decode
#: feeder.  merged()/len() drain the worker and fold its partials.
COMPACT_ROWS = 1 << 20

_MAX_CHROM = 1 << 16
_MAX_COORD = 1 << 31


class JuncTally:
    """Strand-resolved junction counts keyed by (chrom, start, end).

    Canonical merged form: keys (n, 3) int64 sorted lexicographically by
    (chrom, start, end), vals (n, 2) int64 [fwd, rev] — exactly the layout
    the finalize join (finalize.junction_counters), the JuncCount writer and
    the checkpoint snapshot consume, with no dict round-trip.  Internally the
    keys live packed (k1, k2e) for cheap re-sorting.
    """

    def __init__(self):
        self._k1 = np.zeros(0, np.int64)  # chrom<<32 | start, sorted
        self._k2e = np.zeros(0, np.int64)  # end (tie key within k1)
        self._vals = np.zeros((0, 2), np.int64)
        self._pending: list[tuple[np.ndarray, np.ndarray]] = []  # (k1, k2) raw
        self._pending_rows = 0
        # background compaction: one short-lived worker at a time compacts a
        # moved-out batch of pending chunks AND folds it into the running
        # background accumulator (worker-owned between spawns), so the final
        # drain merges one already-unique partial instead of re-sorting the
        # whole stream's rows (the fold was 11 s at 50M reads / 14M gaps
        # when every partial waited for the end)
        self._worker: threading.Thread | None = None
        self._bg_acc: tuple | None = None  # (k1, k2e, vals) sorted-unique
        self._bg_exc: BaseException | None = None
        self._bg_lock = threading.Lock()
        # overflow partials folded synchronously when the worker can't keep
        # pace (bounded-memory guarantee); consumed by _compact()
        self._sync_partials: list[tuple] = []

    # -- pickling -------------------------------------------------------------
    # The tally crosses process boundaries in the multi-host merge path
    # (parallel/multihost.py ships per-process partials to host 0).  Thread
    # and lock state is process-local: drain the worker and serialize only the
    # canonical sorted-unique arrays, then rebuild fresh thread state on load.
    def __getstate__(self):
        self._compact()
        return {"_k1": self._k1, "_k2e": self._k2e, "_vals": self._vals}

    def __setstate__(self, state):
        self.__init__()
        self._k1 = state["_k1"]
        self._k2e = state["_k2e"]
        self._vals = state["_vals"]

    # -- accumulation ---------------------------------------------------------
    def add_batch(self, b) -> None:
        """Append one PackedBatch's gap columns (pack only, no sort)."""
        n = b.n_gaps
        if n == 0:
            return
        c = b.gap_chrom[:n].astype(np.int64)
        keep = c >= 0
        c = c[keep]
        if c.size == 0:
            return
        s = b.gap_start[:n][keep].astype(np.int64)
        e = b.gap_end[:n][keep].astype(np.int64)
        st = b.gap_strand[:n][keep].astype(np.int64)
        if c.max() >= _MAX_CHROM or e.max() >= _MAX_COORD:
            raise ValueError(
                "junction key out of packing range (chrom id >= 2^16 or "
                "coordinate >= 2^31)"
            )
        self._pending.append(((c << 32) | s, (e << 1) | st))
        self._pending_rows += c.size
        if self._pending_rows >= COMPACT_ROWS:
            self._spawn_bg()

    def _spawn_bg(self) -> None:
        """Move the pending chunks to a daemon compaction worker.  At most
        one worker runs at a time; if it is busy when raw pending growth
        crosses 4x the threshold, fold synchronously so memory stays bounded
        even under a worker that can't keep pace with the producer."""
        if self._worker is not None and self._worker.is_alive():
            if self._pending_rows >= 4 * COMPACT_ROWS:
                # compacted partials are unique rows (bounded by the genome's
                # junction count); the next worker spawn or drain folds them
                self._sync_partials.append(_compact_chunks(self._pending))
                self._pending = []
                self._pending_rows = 0
            return
        chunks = self._pending
        self._pending = []
        self._pending_rows = 0
        extra = self._sync_partials
        self._sync_partials = []

        def work():
            try:
                part = _compact_chunks(chunks)
                with self._bg_lock:
                    acc = self._bg_acc
                parts = [part] + extra + ([acc] if acc is not None else [])
                if len(parts) > 1:
                    part = _reduce_sorted(
                        np.concatenate([p[0] for p in parts]),
                        np.concatenate([p[1] for p in parts]),
                        np.concatenate([p[2] for p in parts]),
                    )
                with self._bg_lock:
                    self._bg_acc = part
            except BaseException as e:  # surface from _compact(), not stderr
                with self._bg_lock:
                    self._bg_exc = e

        t = threading.Thread(target=work, daemon=True)
        t.start()
        self._worker = t

    def add_rows(self, keys3: np.ndarray, vals2: np.ndarray) -> None:
        """Merge pre-counted (n,3) keys + (n,2) [fwd,rev] vals (checkpoint
        restore, cross-shard merges)."""
        keys3 = np.asarray(keys3, np.int64).reshape(-1, 3)
        if len(keys3) == 0:
            return
        self._compact()
        k1 = np.concatenate([self._k1, (keys3[:, 0] << 32) | keys3[:, 1]])
        k2e = np.concatenate([self._k2e, keys3[:, 2]])
        vals = np.concatenate([self._vals, np.asarray(vals2, np.int64)])
        self._k1, self._k2e, self._vals = _reduce_sorted(k1, k2e, vals)

    def _compact(self) -> None:
        """Drain the background worker and fold every partial (plus any
        still-pending raw chunks) into the canonical sorted-unique arrays."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        with self._bg_lock:
            acc, self._bg_acc = self._bg_acc, None
            exc, self._bg_exc = self._bg_exc, None
        if exc is not None:
            raise RuntimeError("junction compaction worker failed") from exc
        parts = [acc] if acc is not None else []
        parts.extend(self._sync_partials)
        self._sync_partials = []
        if self._pending:
            parts.append(_compact_chunks(self._pending))
            self._pending = []
            self._pending_rows = 0
        if not parts:
            return
        nk1 = np.concatenate([self._k1] + [p[0] for p in parts])
        nk2e = np.concatenate([self._k2e] + [p[1] for p in parts])
        nvals = np.concatenate([self._vals] + [p[2] for p in parts])
        self._k1, self._k2e, self._vals = _reduce_sorted(nk1, nk2e, nvals)

    # -- views ---------------------------------------------------------------
    def merged(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys (n,3) int64 sorted by (chrom,start,end), vals (n,2) int64)."""
        self._compact()
        keys = np.empty((len(self._k1), 3), np.int64)
        keys[:, 0] = self._k1 >> 32
        keys[:, 1] = self._k1 & 0xFFFFFFFF
        keys[:, 2] = self._k2e
        return keys, self._vals

    def as_dict(self) -> dict:
        """{(c, s, e): [fwd, rev]} — test/back-compat view, not the hot path."""
        keys, vals = self.merged()
        return {
            tuple(k): [int(v[0]), int(v[1])]
            for k, v in zip(keys.tolist(), vals.tolist())
        }

    def __bool__(self) -> bool:
        with self._bg_lock:
            has_acc = self._bg_acc is not None and len(self._bg_acc[0]) > 0
        return (
            bool(self._pending)
            or bool(self._sync_partials)
            or has_acc
            or (self._worker is not None and self._worker.is_alive())
            or len(self._k1) > 0
        )

    def __len__(self) -> int:
        self._compact()
        return len(self._k1)


def _compact_chunks(chunks: list) -> tuple:
    """Raw (k1, k2-with-strand) chunk list -> sorted unique
    (k1, k2e, vals(n,2)) partial.  Pure function (safe off-thread)."""
    k1 = np.concatenate([p[0] for p in chunks])
    k2 = np.concatenate([p[1] for p in chunks])
    # count per unique (k1, k2) row (strand still packed in k2's low bit)
    order = np.lexsort((k2, k1))
    k1 = k1[order]
    k2 = k2[order]
    new = np.empty(len(k1), bool)
    new[0] = True
    np.not_equal(k1[1:], k1[:-1], out=new[1:])
    new[1:] |= k2[1:] != k2[:-1]
    idx = np.flatnonzero(new)
    uk1 = k1[idx]
    uk2 = k2[idx]
    cnt = np.diff(np.append(idx, len(k1)))
    # fold the strand bit into the 2-wide vals plane
    vals = np.zeros((len(uk1), 2), np.int64)
    vals[np.arange(len(uk1)), uk2 & 1] = cnt
    return np.ascontiguousarray(uk1), np.ascontiguousarray(uk2 >> 1), vals


def _reduce_sorted(k1: np.ndarray, k2e: np.ndarray, vals: np.ndarray):
    """Sum vals rows sharing a (k1, k2e) key; returns sorted unique keys."""
    if len(k1) == 0:
        return k1, k2e, vals
    order = np.lexsort((k2e, k1))
    k1 = k1[order]
    k2e = k2e[order]
    vals = vals[order]
    new = np.empty(len(k1), bool)
    new[0] = True
    np.not_equal(k1[1:], k1[:-1], out=new[1:])
    new[1:] |= k2e[1:] != k2e[:-1]
    idx = np.flatnonzero(new)
    return (
        np.ascontiguousarray(k1[idx]),
        np.ascontiguousarray(k2e[idx]),
        np.add.reduceat(vals, idx, axis=0),
    )


def coerce_tally(tally) -> "JuncTally":
    """Accept a plain {(c,s,e): [fwd,rev]} dict (tests, old checkpoints) or a
    JuncTally; return a JuncTally."""
    if isinstance(tally, JuncTally):
        return tally
    t = JuncTally()
    if tally:
        keys = np.array(sorted(tally.keys()), dtype=np.int64)
        vals = np.array([tally[tuple(k)] for k in keys.tolist()], dtype=np.int64)
        t.add_rows(keys, vals)
    return t
