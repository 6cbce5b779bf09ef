"""Sparse splice-junction tally, fully vectorized.

The one counter that stays on the host (ops/step.py docstring): observed
splice junctions have sparse dynamic (chrom, start, end) keys that do not map
to dense device scatter targets, so the engine tallies them host-side.  The
reference incremented a std::map per gap (SURVEY.md §2 row 10, historical
src/irfinder/ReadBlockProcessor.cpp [R]); the first TPU build used a Python
dict with a per-unique-key loop per batch, which became the bottleneck on
realistic spliced-read mixes (~25-35% of RNA-seq reads carry N CIGAR ops).

This accumulator never touches a Python-level loop per row: each batch packs
its gap columns into a uint16 chromosome column and one int64 key per row
(O(n) arithmetic, no sort), and pending chunks are compacted whenever their
row total crosses a threshold — amortized O(n log n) overall, bounded memory.

Key packing, one non-negative int64 within a chromosome (chrom < 2^16,
start and end < 2^31), in (start, end, strand) order:
    raw row      start << 32 | end << 1 | strand
    junction     start << 31 | end      (the raw key >> 1: strand folded
                                         into the 2-wide vals plane)
A compaction groups rows by chromosome (a stable radix sort of the uint16
column, skipped when the rows hold one chromosome, as a coordinate-sorted
BAM's batches do) and sorts each chromosome's keys by value.
"""

from __future__ import annotations

import threading

import numpy as np

#: Hand pending chunks to the background compaction worker at this many raw
#: rows.  Compactions (a sort of the pending rows' packed keys) run on a
#: daemon thread so they ride idle host cycles during streaming instead of
#: landing as one long sort on the finalize critical path; numpy's sorts
#: release the GIL, so the worker genuinely overlaps the decode feeder.
#: merged()/len() drain the worker and fold its partials.
COMPACT_ROWS = 1 << 20

_MAX_CHROM = 1 << 16
_MAX_COORD = 1 << 31
_END_MASK = _MAX_COORD - 1


class JuncTally:
    """Strand-resolved junction counts keyed by (chrom, start, end).

    Canonical merged form: keys (n, 3) int64 sorted lexicographically by
    (chrom, start, end), vals (n, 2) int64 [fwd, rev] — exactly the layout
    the finalize join (finalize.junction_counters), the JuncCount writer and
    the checkpoint snapshot consume, with no dict round-trip.  Internally a
    junction is its chromosome (uint16) and its packed key start << 31 | end.
    ``gap_rows`` counts the raw gap rows add_batch took.
    """

    def __init__(self):
        self._chrom = np.zeros(0, np.uint16)  # sorted, with _key within it
        self._key = np.zeros(0, np.int64)  # start << 31 | end
        self._vals = np.zeros((0, 2), np.int64)
        self._pending: list[tuple[np.ndarray, np.ndarray]] = []  # (chrom, raw key)
        self._pending_rows = 0
        self.gap_rows = 0
        # background compaction: one short-lived worker at a time compacts a
        # moved-out batch of pending chunks AND folds it into the running
        # background accumulator (worker-owned between spawns), so the final
        # drain merges one already-unique partial instead of re-sorting the
        # whole stream's rows
        self._worker: threading.Thread | None = None
        self._bg_acc: tuple | None = None  # (chrom, key, vals) sorted-unique
        self._bg_exc: BaseException | None = None
        self._bg_lock = threading.Lock()
        # overflow partials folded synchronously when the worker can't keep
        # pace (bounded-memory guarantee); consumed by _compact()
        self._sync_partials: list[tuple] = []

    # -- pickling -------------------------------------------------------------
    # The tally crosses process boundaries in the multi-host merge path
    # (parallel/multihost.py ships per-process partials to host 0).  Thread
    # and lock state is process-local: drain the worker and serialize only the
    # canonical sorted-unique arrays, as (chrom << 32 | start, end, vals),
    # then rebuild fresh thread state on load.
    def __getstate__(self):
        self._compact()
        k1 = (self._chrom.astype(np.int64) << 32) | (self._key >> 31)
        return {"_k1": k1, "_k2e": self._key & _END_MASK, "_vals": self._vals}

    def __setstate__(self, state):
        self.__init__()
        k1 = state["_k1"]
        self._chrom = (k1 >> 32).astype(np.uint16)
        self._key = ((k1 & 0xFFFFFFFF) << 31) | state["_k2e"]
        self._vals = state["_vals"]

    # -- accumulation ---------------------------------------------------------
    def add_batch(self, b) -> None:
        """Append one PackedBatch's gap columns (pack only, no sort)."""
        n = b.n_gaps
        if n == 0:
            return
        c = b.gap_chrom[:n]
        keep = c >= 0
        c = c[keep]
        if c.size == 0:
            return
        s = b.gap_start[:n][keep].astype(np.int64)
        e = b.gap_end[:n][keep].astype(np.int64)
        if c.max() >= _MAX_CHROM or max(s.max(), e.max()) >= _MAX_COORD:
            raise ValueError(
                "junction key out of packing range (chrom id >= 2^16 or "
                "coordinate >= 2^31)"
            )
        self._pending.append((c.astype(np.uint16), (s << 32) | (e << 1) | b.gap_strand[:n][keep]))
        self._pending_rows += c.size
        self.gap_rows += c.size
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
                self._sync_partials.append(_tally_rows(self._pending))
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
                part = _tally_rows(chunks)
                with self._bg_lock:
                    acc = self._bg_acc
                part = _fold([part] + extra + ([acc] if acc is not None else []))
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
        c, s, e = keys3.T
        if keys3.min() < 0 or c.max() >= _MAX_CHROM or max(s.max(), e.max()) >= _MAX_COORD:
            raise ValueError("junction key out of packing range")
        self._compact()
        part = _reduce(c.astype(np.uint16), (s << 31) | e, np.asarray(vals2, np.int64).reshape(-1, 2))
        self._chrom, self._key, self._vals = _fold([(self._chrom, self._key, self._vals), part])

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
        parts = [(self._chrom, self._key, self._vals)]
        if acc is not None:
            parts.append(acc)
        parts.extend(self._sync_partials)
        self._sync_partials = []
        if self._pending:
            parts.append(_tally_rows(self._pending))
            self._pending = []
            self._pending_rows = 0
        if len(parts) > 1:
            self._chrom, self._key, self._vals = _fold(parts)

    # -- views ---------------------------------------------------------------
    def merged(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys (n,3) int64 sorted by (chrom,start,end), vals (n,2) int64)."""
        self._compact()
        keys = np.empty((len(self._key), 3), np.int64)
        keys[:, 0] = self._chrom
        keys[:, 1] = self._key >> 31
        keys[:, 2] = self._key & _END_MASK
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
            or len(self._key) > 0
        )

    def __len__(self) -> int:
        self._compact()
        return len(self._key)


def _cuts(c: np.ndarray) -> np.ndarray:
    """Start of every run of equal values in the sorted ``c`` after the
    first."""
    return np.flatnonzero(c[1:] != c[:-1]) + 1


def _tally_rows(chunks: list) -> tuple:
    """Raw (chrom, start << 32 | end << 1 | strand) chunks -> sorted unique
    (chrom, key, vals (n,2)) partial.  Pure function (safe off-thread)."""
    c = np.concatenate([p[0] for p in chunks])
    k = np.concatenate([p[1] for p in chunks])
    if c.min() == c.max():
        k.sort()
        cuts = np.zeros(0, np.intp)
    else:
        order = np.argsort(c, kind="stable")
        c = c[order]
        k = k[order]
        cuts = _cuts(c)
        for lo, hi in zip([0, *cuts], [*cuts, len(k)]):
            k[lo:hi].sort()
    # one row per junction, its forward and reverse rows (adjacent, the
    # strand the key's low bit) counted into the 2-wide vals plane
    jk = k >> 1
    new = np.empty(len(k), bool)
    new[0] = True
    np.not_equal(jk[1:], jk[:-1], out=new[1:])
    new[cuts] = True
    first = np.flatnonzero(new)
    row = np.cumsum(new) - 1
    vals = np.bincount(2 * row + (k & 1), minlength=2 * len(first)).reshape(-1, 2)
    return c[first], jk[first], vals.astype(np.int64, copy=False)


def _reduce(c: np.ndarray, k: np.ndarray, vals: np.ndarray) -> tuple:
    """Sort (chrom, key) rows and sum the vals of rows sharing a key: the
    rows grouped by chromosome (a stable radix sort of the uint16 column),
    then each chromosome's keys by a stable argsort, which merges presorted
    runs in about linear time."""
    if len(k) == 0:
        return c, k, vals
    order = np.argsort(c, kind="stable")
    cuts = _cuts(c[order])
    for lo, hi in zip([0, *cuts], [*cuts, len(k)]):
        seg = order[lo:hi]
        order[lo:hi] = seg[np.argsort(k[seg], kind="stable")]
    c = c[order]
    k = k[order]
    new = np.empty(len(k), bool)
    new[0] = True
    np.not_equal(k[1:], k[:-1], out=new[1:])
    new[cuts] = True
    idx = np.flatnonzero(new)
    return c[idx], k[idx], np.add.reduceat(np.take(vals, order, axis=0), idx, axis=0)


def _merge(a: tuple, b: tuple) -> tuple:
    """Two sorted-unique (chrom, key, vals) partials -> one, by a
    searchsorted merge: each of ``b``'s rows finds its place among ``a``'s
    within its chromosome; a key in both adds its vals to ``a``'s row, the
    others are placed before the row they found."""
    ca, ka, va = a
    cb, kb, vb = b
    pos = np.empty(len(kb), np.intp)
    cuts = _cuts(cb)
    for lo, hi in zip([0, *cuts], [*cuts, len(kb)]):
        a0, a1 = np.searchsorted(ca, cb[lo], "left"), np.searchsorted(ca, cb[lo], "right")
        pos[lo:hi] = a0 + np.searchsorted(ka[a0:a1], kb[lo:hi])
    at = np.minimum(pos, len(ka) - 1)
    same = (pos < len(ka)) & (ka[at] == kb) & (ca[at] == cb)
    new = np.flatnonzero(~same)
    # each row's place in the merged order: a's row i moves down by the new
    # rows placed at or before it, the j-th new row by the j new rows ahead
    dest = np.arange(len(ka)) + np.cumsum(np.bincount(pos[new], minlength=len(ka) + 1)[: len(ka)])
    order = np.empty(len(ka) + len(new), np.intp)
    order[dest] = np.arange(len(ka))
    order[pos[new] + np.arange(len(new))] = len(ka) + new
    vals = np.take(np.concatenate([va, vb]), order, axis=0)
    hit = np.flatnonzero(same)
    vals[dest[pos[hit]]] += np.take(vb, hit, axis=0)
    return np.concatenate([ca, cb])[order], np.concatenate([ka, kb])[order], vals


def _fold(parts: list) -> tuple:
    """Sorted-unique (chrom, key, vals) partials -> one, merged in turn,
    the largest first."""
    parts = sorted((p for p in parts if len(p[1])), key=lambda p: -len(p[1])) or parts[:1]
    out = parts[0]
    for p in parts[1:]:
        out = _merge(out, p)
    return out


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
