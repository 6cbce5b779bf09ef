"""The port's batch-by-batch library API against the JAX package's.

A library caller drives ``Engine`` one batch at a time, as the JAX
package's own tests do: ``Engine(ref, cap_frags=...)``, ``process_batch``,
``flush_pending``, ``counters_host`` and ``results(fc=None, st=None)``;
``MeshEngine.flush_pending``; and the long-read batch geometry.  The port
runs on the CPU (count_step_plain and all_stats_plain), the JAX package on
its CPU backend, both on the same seeded inputs.  Exact: integer counters equal, tables byte-identical.
"""

import dataclasses
import io
import os

import numpy as np
import pytest

from irfinder_tpu import format as jfmt
from irfinder_tpu.engine import Engine as JEngine
from irfinder_tpu.engine import open_decoder as j_open_decoder
from irfinder_tpu.io.bamgen import write_realistic_bam
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch import format as fmt
from irfinder_tpu_torch.config import RunConfig
from irfinder_tpu_torch.convert import compiled_ref_from_numpy
from irfinder_tpu_torch.engine import Engine, open_decoder, run_bam
from irfinder_tpu_torch.io.batch import PackedBatch

TABLES = (
    "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt", "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt", "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    "WARNINGS",
)
#: case -> (reference, write_realistic_bam kwargs, cap_frags)
CASES = {
    "unstranded": ("one", dict(n_pairs=2500, seed=21), 1024),
    "stranded": ("one", dict(n_pairs=6000, seed=2, stranded=True), 4096),
    "three_chroms": ("three", dict(n_pairs=3000, seed=22), 512),
}


@pytest.fixture(scope="module")
def refs():
    # the references of tests/test_torch_engine.py
    return {
        "one": synth_ref(n_genes=40),
        "three": synth_ref(n_genes=60, n_chroms=3, chrom_len=20_000_000, seed=2),
    }


@pytest.fixture(scope="module")
def prefs(refs):
    return {k: compiled_ref_from_numpy({f.name: getattr(r, f.name) for f in dataclasses.fields(r)})
            for k, r in refs.items()}


def _read(d, name):
    with open(os.path.join(d, name), "rb") as fh:
        return fh.read()


def _ir_text(rows, fmt_module) -> str:
    buf = io.StringIO()
    fmt_module.write_ir_table(buf, rows)
    return buf.getvalue()


def _same_counters(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def _same_rows(got: dict, want: dict, want_fmt=jfmt) -> None:
    for mode in ("nondir", "dir"):
        key = f"rows_{mode}"
        assert _ir_text(got[key], fmt) == _ir_text(want[key], want_fmt), key
    assert bool(got["stranded"]) == bool(want["stranded"])
    assert bool(got["flip_strand"]) == bool(want["flip_strand"])


@pytest.mark.parametrize("case", list(CASES))
def test_process_batch_matches_jax(case, refs, prefs, tmp_path):
    """process_batch over every decoded batch, then counters_host equal key
    by key to the JAX Engine's, results() rows equal to its results() rows,
    results(fc) equal to results(); a second state counted through
    ``st=`` gives the same."""
    name, bam_kw, cap = CASES[case]
    bam = str(tmp_path / "in.bam")
    write_realistic_bam(bam, refs[name], **bam_kw)

    jh, jbatches, _ = j_open_decoder(refs[name], bam, cap)
    jeng = JEngine(refs[name], cap_frags=cap)
    jeng.reset(n_refids=len(jh.ref_names))
    for b in jbatches:
        jeng.process_batch(b)
    jfc = jeng.counters_host()
    jres = jeng.results()

    header, batches, _ = open_decoder(prefs[name], bam, cap)
    batches = list(batches)
    eng = Engine(prefs[name], cap_frags=cap, device="cpu")
    eng.reset(n_refids=len(header.ref_names))
    for b in batches:
        eng.process_batch(b)
    assert eng.metrics.batches == jeng.metrics.batches == len(batches) > 1
    assert eng.metrics.wire_bytes == sum(b.fused_h2d().nbytes for b in batches)
    fc = eng.counters_host()
    _same_counters(fc, jfc)
    assert fc["depth"].sum() > 0 and fc["exact_cnt"].sum() > 0
    res = eng.results()
    _same_rows(res, jres)
    if case == "stranded":
        assert eng.metrics.is_stranded, "the stranded case must exercise the dir polarity path"
    # the host counters finalized again: directionality recorded, same rows
    eng.metrics.dir_informative = -1
    _same_rows(eng.results(fc), jres)
    assert eng.metrics.dir_informative == jeng.metrics.dir_informative > 0

    st = eng.new_state(n_refids=len(header.ref_names))
    for b in batches:
        eng.process_batch(b, st)
    _same_counters(eng.counters_host(st), jfc)
    _same_rows(eng.results(st=st), jres)
    _same_rows(eng.results(fc, st), jres)
    assert st.metrics.batches == len(batches)


def test_counters_host_is_a_copy(prefs, tmp_path):
    """The host counters do not change when the engine counts on."""
    ref = prefs["one"]
    bam = str(tmp_path / "in.bam")
    write_realistic_bam(bam, ref, n_pairs=1500, seed=23)
    header, batches, _ = open_decoder(ref, bam, 256)
    batches = list(batches)
    eng = Engine(ref, cap_frags=256, device="cpu")
    eng.reset(n_refids=len(header.ref_names))
    eng.process_batch(batches[0])
    fc = eng.counters_host()
    before = {k: np.array(v) for k, v in fc.items()}
    for b in batches[1:]:
        eng.process_batch(b)
    _same_counters(fc, before)
    assert int(eng.counters_host()["n_frags"]) > int(fc["n_frags"])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_process_batch_refuses_unfilled_columns(package, refs, prefs):
    """A batch whose block/frag columns were never filled raises, as in the
    JAX package, and counts nothing."""
    b = PackedBatch.empty(4096, 4096, 1024)
    b.columns_full = False
    eng = Engine(prefs["one"], device="cpu") if package == "port" else JEngine(refs["one"])
    eng.reset(n_refids=1)
    with pytest.raises(RuntimeError, match="columns_full=False"):
        eng.process_batch(b)
    assert eng.metrics.batches == 0


@pytest.mark.parametrize("engine", ["Engine", "MeshEngine"])
def test_flush_pending(engine, refs, prefs, tmp_path):
    """flush_pending is a no-op that the JAX package's call sites can make:
    after half the batches and a flush, the port's engine (or a dp x genome
    mesh) gives the rows the JAX Engine gives at the same point."""
    from irfinder_tpu_torch.engine_mesh import MeshEngine, MeshSpec

    bam = str(tmp_path / "in.bam")
    write_realistic_bam(bam, refs["three"], n_pairs=2000, seed=24)
    jh, jbatches, _ = j_open_decoder(refs["three"], bam, 256)
    jbatches = list(jbatches)
    half = len(jbatches) // 2
    jeng = JEngine(refs["three"], cap_frags=256)
    jeng.reset(n_refids=len(jh.ref_names))
    for b in jbatches[:half]:
        jeng.process_batch(b)
    jeng.flush_pending()
    jres = jeng.results()

    header, batches, _ = open_decoder(prefs["three"], bam, 256)
    batches = list(batches)[:half]
    assert half > 1
    if engine == "Engine":
        eng = Engine(prefs["three"], cap_frags=256, device="cpu")
        eng.reset(n_refids=len(header.ref_names))
        st = None
    else:
        eng = MeshEngine(prefs["three"], MeshSpec(dp=2, genome=2), ["cpu"] * 4, cap_frags=256)
        st = eng.new_state(n_refids=len(header.ref_names))
    for b in batches:
        eng.process_batch(b, st)
        assert eng.flush_pending() is None
    _same_rows(eng.results() if st is None else eng.results(st), jres)
    if st is None:
        _same_counters(eng.counters_host(), jeng.counters_host())


def test_engine_cap_frags(refs, prefs):
    """Engine(ref, cap_frags=...) stores it, as the JAX Engine does; the
    device stays the port's keyword."""
    assert Engine(prefs["one"], cap_frags=512, device="cpu").cap_frags == 512
    assert JEngine(refs["one"], cap_frags=512).cap_frags == 512
    assert Engine(prefs["one"], device="cpu").cap_frags == JEngine(refs["one"]).cap_frags == 1 << 15
    assert str(Engine(prefs["one"], 256, "cpu").device) == "cpu"


def _longread_bam(ref, n_exons=120, n_reads=8) -> bytes:
    """tests/test_longread.py's reads, written with the port's bamwrite:
    n_exons aligned blocks each, 100M + N-gap ladders; each read's first
    gap lands exactly on an annotated intron."""
    from irfinder_tpu_torch.io import bamwrite

    recs = []
    for r in range(n_reads):
        k = r * 3
        istart, iend = int(ref.intron_start[k]), int(ref.intron_end[k])
        cig = [(100, "M"), (iend - istart, "N")]
        for _ in range(n_exons - 1):
            cig += [(100, "M"), (500, "N")]
        cig.append((100, "M"))
        cigar = "".join(f"{ln}{op}" for ln, op in cig)
        recs.append(bamwrite.make_single(f"lr{r}", int(ref.intron_chrom[k]), istart - 100, cigar, mapq=60))
    buf = io.BytesIO()
    bamwrite.write_bam(buf, ref.chroms, [2_000_000_000] * len(ref.chroms), recs)
    return buf.getvalue()


def test_longread_process_batch_matches_oracle():
    """tests/test_longread.py's 120-exon reads through the port's
    process_batch: every counter equal to the port's NumPy oracle's, and the
    rows of results(fc) equal to the oracle's rows."""
    from irfinder_tpu_torch import oracle
    from irfinder_tpu_torch.io.bampy import decode_bam
    from irfinder_tpu_torch.synth import synth_ref as port_synth_ref

    ref = port_synth_ref(n_genes=400)
    raw = _longread_bam(ref)
    idx = {c: i for i, c in enumerate(ref.chroms)}
    _, batches, stats = decode_bam(io.BytesIO(raw), idx, cap_frags=64)
    batches = list(batches)
    assert stats.reads_total == 8
    assert sum(b.n_blocks for b in batches) > 8 * 50 and sum(b.n_gaps for b in batches) > 8 * 50

    orc = oracle.OracleCounters.create(ref)
    eng = Engine(ref, cap_frags=64, device="cpu")
    eng.reset(n_refids=len(ref.chroms))
    for b in batches:
        orc.add_batch(b)
        eng.process_batch(b)
    fc = eng.counters_host()
    for k in ("depth", "start_cnt", "end_cnt", "exact_cnt", "span_hits", "roi_cnt"):
        np.testing.assert_array_equal(fc[k].astype(np.int64), getattr(orc, k), err_msg=k)
    assert {i: int(v) for i, v in enumerate(fc["chr_frag"]) if v} == orc.chr_frag
    assert int(fc["n_frags"]) == orc.n_frags == 8
    assert orc.exact_cnt.sum() == 8
    res = eng.results(fc)
    for mode in ("nondir", "dir"):
        want = oracle.intron_rows(orc, mode=mode, flip_strand=bool(res["flip_strand"]))
        assert _ir_text(res[f"rows_{mode}"], fmt) == _ir_text(want, fmt), mode


def test_longread_geometries_are_byte_identical(prefs, tmp_path):
    """write_longread_bam (16-96 exon blocks, 10-100 kb spans) counted in the
    long-read batch geometry and in the paired one: fewer, wider batches,
    the same tables byte for byte."""
    from irfinder_tpu_torch.conformance import write_longread_bam
    from irfinder_tpu_torch.io.batch import LONGREAD_BLOCKS_PER_FRAG

    ref = prefs["three"]
    bam = str(tmp_path / "ont.bam")
    assert write_longread_bam(bam, ref, n_reads=2000, seed=5).n_records == 2000
    _, batches, _ = open_decoder(ref, bam, 256, long_reads=True)
    first = next(iter(batches))
    assert first.cap_blocks == 256 * LONGREAD_BLOCKS_PER_FRAG
    assert first.n_blocks > 10 * first.n_frags
    outs = {}
    ms = {}
    for lr in (True, False):
        outs[lr] = str(tmp_path / f"long_reads_{lr}")
        ms[lr] = run_bam(ref, bam, outs[lr], config=RunConfig(cap_frags=256, long_reads=lr), device="cpu")
    assert ms[True].fragments == ms[False].fragments == 2000
    assert ms[True].batches < ms[False].batches
    for t in TABLES:
        assert _read(outs[True], t) == _read(outs[False], t), t
