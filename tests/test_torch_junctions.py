"""The port's junction tally and join against the JAX package's, on the CPU.

``irfinder_tpu_torch.junctions.JuncTally`` packs each gap row as one int64
key within its chromosome and sorts on it; ``irfinder_tpu.junctions.JuncTally``
(two keys, lexsort) is the reference: merged(), as_dict() and the pickled
state agree on unsorted whole-genome batches, one-chromosome batches, keys
at the packing range's edges, pad lanes, the background worker and the
synchronous fold, add_rows between batches, and a pickle round trip.

``finalize.junction_counters`` and ``detect_directionality`` read map-side
tables made once per map (``junction_tables``, ``pair_strands``); they agree
with the JAX package's on a three-chromosome map and on a map where a pair is
shared by introns of both strands, and the tables are made anew only when a
field they come from is replaced.  run_bam records ``junction_rows`` and
``junction_tables_made``.
"""

import dataclasses
import io
import json
import os
import pickle
import threading

import numpy as np
import pytest

import irfinder_tpu.junctions as JJ
import irfinder_tpu_torch.junctions as PJ
from irfinder_tpu.finalize import detect_directionality as j_detect
from irfinder_tpu.finalize import junction_counters as j_junction_counters
from irfinder_tpu.refio.compile import CompiledRef as JCompiledRef
from irfinder_tpu_torch import finalize as F
from irfinder_tpu_torch.refio.compile import compile_reference
from irfinder_tpu_torch.refio.gtf import Exon
from irfinder_tpu_torch.synth import synth_exons

EDGE_CHROMS = (0, 1, (1 << 16) - 2, (1 << 16) - 1)
EDGE_COORDS = (0, 1, (1 << 31) - 2, (1 << 31) - 1)


class FakeBatch:
    """A PackedBatch's gap columns: ``rows`` (n, 4) of (chrom, start, end,
    strand), then ``pad`` garbage lanes past n_gaps."""

    def __init__(self, rows, pad: int = 0, dtype=np.int32):
        rows = np.asarray(rows, dtype=np.int64).reshape(-1, 4)
        self.n_gaps = len(rows)
        full = np.concatenate([rows, np.full((pad, 4), 7, np.int64)]).astype(dtype)
        self.gap_chrom, self.gap_start, self.gap_end, self.gap_strand = (
            np.ascontiguousarray(full[:, i]) for i in range(4)
        )


def random_rows(rng, n, chroms, pool=40, lo=0, hi=200_000):
    """``n`` gap rows over ``chroms`` with many repeated junctions: starts
    and ends drawn from a pool, both strands, a share of pad lanes (-1)."""
    starts = rng.integers(lo, hi, pool)
    c = rng.choice(np.asarray(chroms), n)
    c[rng.random(n) < 0.1] = -1
    s = rng.choice(starts, n)
    e = s + rng.choice(rng.integers(1, 5_000, pool), n)
    return np.stack([c, s, e, rng.integers(0, 2, n)], axis=1)


def make_batches(kind: str, rng) -> list:
    if kind == "many_chroms":  # an unsorted whole-genome BAM: 24 chromosomes a batch
        return [FakeBatch(random_rows(rng, 500, range(24)), pad=rng.integers(0, 50)) for _ in range(30)]
    if kind == "one_chrom":  # a coordinate-sorted BAM: one chromosome a batch
        return [FakeBatch(random_rows(rng, 500, [c // 6]), pad=3) for c in range(30)]
    if kind == "edges":
        out = []
        for _ in range(12):
            n = 300
            rows = np.stack([
                rng.choice(EDGE_CHROMS, n), rng.choice(EDGE_COORDS, n),
                rng.choice(EDGE_COORDS, n), rng.integers(0, 2, n),
            ], axis=1)
            out.append(FakeBatch(rows))
        return out
    if kind == "same_keys":  # one junction on every chromosome: equal keys meet at each boundary
        out = []
        for i in range(22):  # chromosome 5 comes last, in a batch of its own
            c = rng.choice([0, 1, 2, 3, 4, 6, 7], 100) if i < 21 else np.full(40, 5)
            out.append(FakeBatch(np.stack([c, 0 * c + 1000, 0 * c + 2000, rng.integers(0, 2, len(c))], axis=1)))
        return out
    if kind == "pads":  # empty, all-pad and padded batches between real ones
        out = []
        for i in range(20):
            if i % 4 == 0:
                out.append(FakeBatch(np.zeros((0, 4)), pad=10))
            elif i % 4 == 1:
                out.append(FakeBatch([[-1, 5, 9, 0]] * 6, pad=4))
            else:
                out.append(FakeBatch(random_rows(rng, 200, [0, 3]), pad=25))
        return out
    raise ValueError(kind)


def fill(tally_cls, batches, extra=None):
    """A tally of ``batches``; with ``extra`` ((keys, vals) rows), add_rows
    of them after every third batch."""
    t = tally_cls()
    for i, b in enumerate(batches):
        t.add_batch(b)
        if extra is not None and i % 3 == 2:
            t.add_rows(*extra)
    return t


def assert_same_tally(p, j):
    pk, pv = p.merged()
    jk, jv = j.merged()
    for a, b in ((pk, jk), (pv, jv)):
        assert a.dtype == b.dtype == np.int64 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert p.as_dict() == j.as_dict()
    ps, js = p.__getstate__(), j.__getstate__()
    assert set(ps) == set(js)
    for k in js:
        assert ps[k].dtype == js[k].dtype and ps[k].flags.c_contiguous
        np.testing.assert_array_equal(ps[k], js[k], err_msg=k)


@pytest.mark.parametrize("compact_rows", [None, 700], ids=["whole", "worker"])
@pytest.mark.parametrize("kind", ["many_chroms", "one_chrom", "same_keys", "edges", "pads"])
def test_tally_matches_jax(kind, compact_rows, monkeypatch):
    """merged(), as_dict() and the pickled state equal the JAX package's;
    with COMPACT_ROWS at 700 the background worker folds partials along
    the way.  ``same_keys`` puts one key on every chromosome, so that equal
    keys of two chromosomes meet in every sort and merge."""
    if compact_rows:
        monkeypatch.setattr(PJ, "COMPACT_ROWS", compact_rows)
    batches = make_batches(kind, np.random.default_rng(len(kind)))
    p, j = fill(PJ.JuncTally, batches), fill(JJ.JuncTally, batches)
    assert len(p) == len(j) > 0 or kind == "pads"
    assert_same_tally(p, j)
    real = sum(int((b.gap_chrom[: b.n_gaps] >= 0).sum()) for b in batches)
    assert p.gap_rows == real


@pytest.mark.parametrize("kind", ["many_chroms", "one_chrom", "same_keys", "edges"])
def test_add_rows_between_batches(kind, monkeypatch):
    """Pre-counted rows (a checkpoint's, another shard's) merged by add_rows
    after every third batch, with the worker running."""
    monkeypatch.setattr(PJ, "COMPACT_ROWS", 900)
    rng = np.random.default_rng(7)
    other = fill(JJ.JuncTally, make_batches(kind, rng)).merged()
    batches = make_batches(kind, rng)
    assert_same_tally(fill(PJ.JuncTally, batches, other), fill(JJ.JuncTally, batches, other))


@pytest.mark.parametrize("drain_at", [1, 21])
def test_drained_tally_takes_a_new_chromosome(drain_at):
    """Drained after ``drain_at`` batches of one key on seven chromosomes,
    the tally folds chromosome 5's rows (the same key) in before
    chromosome 6's, not into them."""
    batches = make_batches("same_keys", np.random.default_rng(4))
    p = PJ.JuncTally()
    for i, b in enumerate(batches):
        if i == drain_at:
            assert len(p) == 7
        p.add_batch(b)
    assert_same_tally(p, fill(JJ.JuncTally, batches))


def test_sync_fold_while_the_worker_is_busy(monkeypatch):
    """A worker held busy: pending rows past 4 x COMPACT_ROWS fold on the
    calling thread (the memory bound), and the drain folds everything."""
    monkeypatch.setattr(PJ, "COMPACT_ROWS", 100)
    gate = threading.Event()
    tally_rows = PJ._tally_rows

    def held(chunks):
        if threading.current_thread() is not threading.main_thread():
            gate.wait(30)
        return tally_rows(chunks)

    monkeypatch.setattr(PJ, "_tally_rows", held)
    rng = np.random.default_rng(11)
    batches = [FakeBatch(random_rows(rng, 150, range(5))) for _ in range(12)]
    p = PJ.JuncTally()
    try:
        folds = 0
        for b in batches:
            p.add_batch(b)
            folds = max(folds, len(p._sync_partials))
        assert folds >= 2 and p._worker.is_alive()
        assert bool(p)
    finally:
        gate.set()
    assert_same_tally(p, fill(JJ.JuncTally, batches))


@pytest.mark.parametrize("state", ["empty", "pending", "compacted"])
def test_pickle_round_trip(state, monkeypatch):
    """Pickling drains the worker and carries the canonical arrays; the
    loaded tally merges further batches as the original would."""
    monkeypatch.setattr(PJ, "COMPACT_ROWS", 600)
    batches = make_batches("many_chroms", np.random.default_rng(3))
    head = {"empty": [], "pending": batches[:1], "compacted": batches[:12]}[state]
    p, j = fill(PJ.JuncTally, head), fill(JJ.JuncTally, head)
    q = pickle.loads(pickle.dumps(p))
    assert_same_tally(q, j)
    for b in batches[12:]:
        q.add_batch(b)
        j.add_batch(b)
    assert_same_tally(q, j)


@pytest.mark.parametrize("row", [
    [1 << 16, 5, 9, 0],
    [0, 5, 1 << 31, 1],
    [3, 1 << 31, (1 << 31) + 4, 0],
], ids=["chrom", "end", "start"])
def test_out_of_range_keys_raise(row):
    """A chromosome id past 2^16 - 1 or a coordinate past 2^31 - 1 does not
    fit the packed key: add_batch and add_rows refuse it."""
    b = FakeBatch([[0, 5, 9, 0], row], dtype=np.int64)
    with pytest.raises(ValueError, match="packing range"):
        PJ.JuncTally().add_batch(b)
    with pytest.raises(ValueError, match="packing range"):
        PJ.JuncTally().add_rows(np.array([row[:3]]), np.array([[1, 0]]))
    if row[1] < 1 << 31:  # the JAX package checks the end and the chrom
        with pytest.raises(ValueError, match="packing range"):
            JJ.JuncTally().add_batch(b)


def test_coerce_tally_matches_jax():
    d = {(0, 5, 9): [2, 1], (1, 3, 7): [0, 4], (0, 5, 8): [1, 0], ((1 << 16) - 1, 0, (1 << 31) - 1): [3, 3]}
    p, j = PJ.coerce_tally(d), JJ.coerce_tally(d)
    assert p.as_dict() == d
    assert_same_tally(p, j)
    assert PJ.coerce_tally(p) is p and not PJ.JuncTally() and p


# -- the join ------------------------------------------------------------------

def _antisense_map():
    """A two-chromosome map where gene G00000's first transcript is also
    annotated on the other strand: its introns' pairs are shared by introns
    of conflicting strands."""
    ex = synth_exons(n_genes=12, n_chroms=2, chrom_len=2_000_000, seed=1)
    first = [e for e in ex if e.transcript_id == "G00000.t1"]
    flip = {"+": "-", "-": "+"}
    ex += [Exon(e.chrom, e.start, e.end, flip[e.strand], "AS0", "AS0", "AS0.t1") for e in first]
    return compile_reference(ex)


MAPS = {
    "three_chroms": lambda: compile_reference(synth_exons(n_genes=60, n_chroms=3, chrom_len=3_000_000, seed=2)),
    "antisense": _antisense_map,
}


def _map(name):
    ref = MAPS[name]()
    jref = JCompiledRef(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})
    return ref, jref


def _junction_batches(ref, rng, n=8000, stranded=True):
    """Gap rows on the map: exact introns (a library's strand mostly), an
    intron's start with another end, an intron's end with another start,
    unannotated gaps, and a chromosome the map does not have."""
    n_chroms = len(ref.chroms)
    i = rng.integers(0, ref.n_introns, n)
    c = ref.intron_chrom[i].astype(np.int64)
    s = ref.intron_start[i].astype(np.int64)
    e = ref.intron_end[i].astype(np.int64)
    strand = ref.intron_strand[i].astype(np.int64) % 2
    if not stranded:
        strand = rng.integers(0, 2, n)
    strand = np.where(rng.random(n) < 0.1, 1 - strand, strand)
    kind = rng.integers(0, 5, n)
    e = np.where(kind == 1, e + rng.integers(1, 50, n), e)
    s = np.where(kind == 2, s - rng.integers(1, 50, n), s)
    s = np.where(kind == 3, rng.integers(0, 1_000_000, n), s)
    e = np.where(kind == 3, s + rng.integers(1, 9_000, n), e)
    c = np.where(kind == 4, rng.choice([n_chroms, n_chroms + 3], n), c)
    rows = np.stack([c, s, e, strand], axis=1)
    return [FakeBatch(rows[k : k + 1000], pad=5) for k in range(0, n, 1000)]


@pytest.mark.parametrize("stranded", [True, False], ids=["stranded", "unstranded"])
@pytest.mark.parametrize("name", list(MAPS))
def test_junction_counters_and_directionality_match_jax(name, stranded):
    ref, jref = _map(name)
    batches = _junction_batches(ref, np.random.default_rng(5), stranded=stranded)
    p, j = fill(PJ.JuncTally, batches), fill(JJ.JuncTally, batches)
    got = F.junction_counters(ref, p)
    want = j_junction_counters(jref, j)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[2].sum() > 100 and got[0].sum() > got[2].sum()
    assert not any(x.any() for x in F.junction_counters(ref, {}))
    ps = F.pair_strands(ref)
    if name == "antisense":
        shared = np.bincount(ref.intron_pair_idx, minlength=ps.size) > 1
        assert (ps[shared] == 2).any()
    for xc in (got[2], got[2][::-1].copy(), np.zeros_like(got[2])):
        assert F.detect_directionality(ref, xc) == j_detect(jref, xc)
    assert F.detect_directionality(ref, got[2])[0] == stranded


JOIN_FIELDS = ("bstart_coord", "bstart_seg", "bend_coord", "bend_seg", "upair_start", "upair_end", "upair_seg")
STRAND_FIELDS = ("upair_start", "intron_pair_idx", "intron_strand")


@pytest.mark.parametrize("field", sorted(set(JOIN_FIELDS + STRAND_FIELDS)))
def test_map_tables_made_once_per_map(field):
    """junction_tables and pair_strands are made on a map's first join and
    read from its cache after; replacing a field one is made from (with an
    equal copy) makes that one anew, and the other stays."""
    ref, _ = _map("three_chroms")
    tables, made = F.junction_tables(ref)
    ps = F.pair_strands(ref)
    same, again_made = F.junction_tables(ref)
    assert made and same is tables and not again_made and F.pair_strands(ref) is ps
    assert not ps.flags.writeable
    setattr(ref, field, getattr(ref, field).copy())
    again, made = F.junction_tables(ref)
    assert made == (field in JOIN_FIELDS) and (again is tables) == (field not in JOIN_FIELDS)
    assert (F.pair_strands(ref) is ps) == (field not in STRAND_FIELDS)
    for a, b in zip(again, tables):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(F.pair_strands(ref), ps)


def test_run_bam_records_junction_counters(tmp_path):
    """run_bam twice on one map: the first call's join makes the map's
    tables (junction_tables_made 1), the second reads them (0);
    junction_rows is the gap rows the decoder handed the tally, and both
    are in metrics.json."""
    from irfinder_tpu_torch.conformance import synth_ref, write_realistic_bam
    from irfinder_tpu_torch.engine import run_bam
    from irfinder_tpu_torch.io import bampy

    ref = synth_ref(n_genes=8, chrom_len=1_000_000)
    bam = str(tmp_path / "s.bam")
    write_realistic_bam(bam, ref, n_pairs=1500, seed=0)
    with open(bam, "rb") as fh:
        _, batches, _ = bampy.decode_bam(io.BytesIO(fh.read()), {c: i for i, c in enumerate(ref.chroms)},
                                         cap_frags=256)
        rows = sum(int((b.gap_chrom[: b.n_gaps] >= 0).sum()) for b in batches)
    seen = []
    for k in range(2):
        out = str(tmp_path / f"out{k}")
        m = run_bam(ref, bam, out, cap_frags=256, device="cpu")
        with open(os.path.join(out, "metrics.json")) as fh:
            saved = json.load(fh)
        assert saved["junction_rows"] == m.junction_rows == rows > 0
        assert saved["junctions_distinct"] == m.junctions_distinct > 0
        seen.append(saved["junction_tables_made"])
    assert seen == [1, 0]
