"""The port's own copies of the host modules, held to the JAX package's.

The port imports nothing of irfinder_tpu: it carries copies of the
semantics, the reference compiler, the synthetic generators, the BAM writer
and both decoders, the finalize and format code and the C++ components.  On
the same inputs (made with numpy from a seed) each copy must give what the
original gives, byte for byte or field for field:

* synth_ref: equal CompiledRef fields;
* write_realistic_bam / write_longread_bam: byte-identical BAM files;
* the native and the Python decoder: identical batches, stats and resume
  tokens;
* CompiledRef.save / load: a reference saved by either package loads in the
  other with equal fields; convert.compiled_ref_from_numpy round-trips;
* an IRTPU_SEMANTICS override: byte-identical tables from both engines;
* conformance.oracle_tables: equal to the tables the JAX package renders
  from its own C++ oracle's counters;
* csrc/host/*.cpp but the decoder and the table formatter: byte-identical
  to native/*/*.cpp; the formatter renders what the original renders, but
  writes a NaN with its sign bit set as "nan", as format.py does;
* the GTF parser: equal Exon lists, from lines and from a gzipped file;
* io/bamwrite: byte-identical BAMs; bampy.read_header / iter_reads: equal
  records;
* the NumPy oracle: counters equal to irfinder_tpu.oracle's, and to the
  port's count step (count_step_plain on the CPU) with its junction join;
* finalize.intron_rows and intron_rows_loop: equal rows from the same
  oracle counters; io/bgzf.read_all: the same bytes;
* goldens.COLUMN_KNOBS: equal.
"""

import dataclasses
import gzip
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from irfinder_tpu import format as jfmt
from irfinder_tpu.finalize import detect_directionality as j_detect
from irfinder_tpu.finalize import intron_table as j_intron_table
from irfinder_tpu.io import bamgen as jbamgen
from irfinder_tpu.io import bampy as jbampy
from irfinder_tpu.native import bamdecode as jbamdecode
from irfinder_tpu.native.oracle_native import NativeOracle as JNativeOracle
from irfinder_tpu.refio.compile import CompiledRef as JCompiledRef
from irfinder_tpu.synth import synth_ref as j_synth_ref
from irfinder_tpu_torch import conformance, synth
from irfinder_tpu_torch.convert import compiled_ref_from_numpy
from irfinder_tpu_torch.io import bamgen, bampy
from irfinder_tpu_torch.io.batch import all_arrays_of
from irfinder_tpu_torch.native import bamdecode
from irfinder_tpu_torch.refio.compile import CompiledRef

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = (
    "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt", "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt", "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    "WARNINGS",
)


def fields(ref) -> dict:
    return {f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)}


def assert_same_ref(a, b):
    fa, fb = fields(a), fields(b)
    assert set(fa) == set(fb)
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        else:
            assert list(fa[k]) == list(fb[k]), k


@pytest.fixture(scope="module")
def jref():
    return j_synth_ref(n_genes=24, chrom_len=1_500_000)


@pytest.fixture(scope="module")
def pref(jref):
    return compiled_ref_from_numpy(fields(jref))


@pytest.mark.parametrize("seed", [0, 3])
def test_synth_ref_matches_jax(seed):
    kw = dict(n_genes=30, chrom_len=2_000_000, seed=seed)
    assert_same_ref(synth.synth_ref(**kw), j_synth_ref(**kw))


def test_synth_batch_arrays_match_jax(jref, pref):
    from irfinder_tpu.synth import synth_batch_arrays as j_arrays

    got, n_got = synth.synth_batch_arrays(pref, n_frags=300, seed=4)
    want, n_want = j_arrays(jref, n_frags=300, seed=4)
    assert n_got == n_want and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("writer", ["realistic", "longread"])
def test_bam_writer_is_byte_identical(writer, jref, pref, tmp_path):
    name = f"write_{writer}_bam"
    kw = dict(n_pairs=700, seed=5, stranded=True) if writer == "realistic" else dict(n_reads=150, seed=6)
    a, b = str(tmp_path / "port.bam"), str(tmp_path / "jax.bam")
    getattr(bamgen, name)(a, pref, **kw)
    getattr(jbamgen, name)(b, jref, **kw)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        ba, bb = fa.read(), fb.read()
    assert len(ba) > 1000 and ba == bb


@pytest.mark.parametrize("decoder", ["native", "python"])
def test_decoders_match_jax(decoder, jref, pref, tmp_path):
    """Both packages' decoders give the same header, batches (every column
    and count) and stats on the same BAM."""
    bam = str(tmp_path / "x.bam")
    jbamgen.write_realistic_bam(bam, jref, n_pairs=1200, seed=7)
    idx = {c: i for i, c in enumerate(jref.chroms)}
    if decoder == "native":
        got = bamdecode.decode_bam_native(bam, idx, cap_frags=256, n_threads=2)
        want = jbamdecode.decode_bam_native(bam, idx, cap_frags=256, n_threads=2)
        batches = list(got[1]), list(want[1])
    else:
        with open(bam, "rb") as fa, open(bam, "rb") as fb:
            got = bampy.decode_bam(fa, idx, cap_frags=256)
            want = jbampy.decode_bam(fb, idx, cap_frags=256)
            batches = list(got[1]), list(want[1])
    assert got[0].ref_names == want[0].ref_names and got[0].ref_lengths == want[0].ref_lengths
    assert len(batches[0]) == len(batches[1]) > 3
    for bg, bw in zip(*batches):
        for k in ("n_blocks", "n_gaps", "n_frags", "n_reads", "cap_blocks", "cap_frags"):
            assert getattr(bg, k) == getattr(bw, k), k
        ag = all_arrays_of(bg)
        aw = {k: getattr(bw, k) for k in ag}
        for k in ag:
            np.testing.assert_array_equal(ag[k], aw[k], err_msg=k)
        np.testing.assert_array_equal(bg.fused_h2d(), bw.fused_h2d())
        assert bg.resume_token == bw.resume_token
    assert sum(b.resume_token is not None for b in batches[0]) >= len(batches[0]) - 1
    sg, sw = dataclasses.asdict(got[2]), dataclasses.asdict(want[2])
    for k in ("reads_total", "reads_admitted", "fragments", "pairs", "singles"):
        assert sg[k] == sw[k], k


@pytest.mark.parametrize("saved_by", ["port", "jax"])
def test_saved_reference_loads_in_the_other_package(saved_by, jref, pref, tmp_path):
    d = str(tmp_path / "ref")
    if saved_by == "port":
        pref.save(d)
        assert_same_ref(JCompiledRef.load(d), jref)
    else:
        jref.save(d)
        assert_same_ref(CompiledRef.load(d), pref)
    with open(os.path.join(d, "ref.json")) as fh:
        assert json.load(fh)["chroms"] == list(jref.chroms)


def test_compiled_ref_from_numpy_round_trips(jref, pref):
    assert isinstance(pref, CompiledRef)
    assert_same_ref(pref, jref)
    again = compiled_ref_from_numpy(fields(pref))
    assert_same_ref(again, pref)
    # a copy, not a view: the port's arrays are its own
    assert not np.shares_memory(again.run_len, pref.run_len)
    f = fields(jref)
    del f["run_len"]
    with pytest.raises(KeyError, match="run_len"):
        compiled_ref_from_numpy(f)


OVERRIDE = {"MIN_MAPQ": 30, "SPANS_OVERHANG": 12, "WARN_LOW_COVER_DEPTH": 1.5,
            "EDGE_DEPTH_WINDOW": 20}

OVERRIDE_SCRIPT = r"""
import dataclasses, json, os, sys
out = sys.argv[1]
from irfinder_tpu import semantics as JS
from irfinder_tpu.engine import run_bam as jax_run_bam
from irfinder_tpu.io.bamgen import write_realistic_bam
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch import semantics as PS
from irfinder_tpu_torch.convert import compiled_ref_from_numpy
from irfinder_tpu_torch.engine import run_bam
want = json.loads(os.environ["IRTPU_SEMANTICS"])
assert JS.SEMANTICS_OVERRIDES == PS.SEMANTICS_OVERRIDES == want, (JS.SEMANTICS_OVERRIDES, PS.SEMANTICS_OVERRIDES)
ref = synth_ref(n_genes=24, chrom_len=1_500_000)
pref = compiled_ref_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})
bam = os.path.join(out, "x.bam")
write_realistic_bam(bam, ref, n_pairs=2500, seed=8, stranded=True)
jax_run_bam(ref, bam, os.path.join(out, "jax"), cap_frags=512)
run_bam(pref, bam, os.path.join(out, "torch"), cap_frags=512, device="cpu")
print("OVERRIDE_OK")
"""


def test_semantics_override_matches_jax(jref, pref, tmp_path):
    """IRTPU_SEMANTICS reaches both packages' semantics the same way: under
    one override both engines write byte-identical tables, which differ from
    the tables without it."""
    env = dict(os.environ)
    env["IRTPU_SEMANTICS"] = json.dumps(OVERRIDE)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", OVERRIDE_SCRIPT, str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, r.stderr
    assert "OVERRIDE_OK" in r.stdout

    def read(d, name):
        with open(os.path.join(tmp_path, d, name), "rb") as fh:
            return fh.read()

    for name in TABLES:
        assert read("torch", name) == read("jax", name), name
    from irfinder_tpu_torch.engine import run_bam

    run_bam(pref, str(tmp_path / "x.bam"), str(tmp_path / "plain"), cap_frags=512, device="cpu")
    assert read("plain", "IRFinder-IR-nondir.txt") != read("torch", "IRFinder-IR-nondir.txt")


def test_oracle_tables_match_jax(jref, pref, tmp_path):
    """The port's conformance counter and table rendering (its own oracle,
    finalize and format copies) against the JAX package's on one BAM."""
    import io

    bam = str(tmp_path / "x.bam")
    jbamgen.write_realistic_bam(bam, jref, n_pairs=1500, seed=9, stranded=True)
    fc, header, _, _ = conformance.oracle_run(pref, bam, 512)
    got = conformance.oracle_tables(pref, header, fc)

    idx = {c: i for i, c in enumerate(jref.chroms)}
    jheader, batches, _ = jbamdecode.decode_bam_native(bam, idx, cap_frags=512)
    orc = JNativeOracle(jref, n_refids=len(jheader.ref_names))
    for b in batches:
        orc.add_batch(b)
    jfc = orc.finalize()
    orc.close()
    for k in jfc:
        np.testing.assert_array_equal(np.asarray(fc[k]), np.asarray(jfc[k]), err_msg=k)
    _, flip, _, _ = j_detect(jref, jfc["exact_cnt"])
    args = (jref, jfc["depth"], jfc["start_cnt"], jfc["end_cnt"], jfc["exact_cnt"], jfc["span_hits"])
    want = {}
    for name, fn in (
        ("IRFinder-IR-nondir.txt", lambda fh: jfmt.write_ir_table(fh, j_intron_table(*args, mode="nondir"))),
        ("IRFinder-IR-dir.txt", lambda fh: jfmt.write_ir_table(
            fh, j_intron_table(*args, mode="dir", flip_strand=flip))),
        ("IRFinder-SpansPoint.txt", lambda fh: jfmt.write_spans_point(fh, jref, jfc["span_hits"])),
        ("IRFinder-ROI.txt", lambda fh: jfmt.write_roi(fh, jref, jfc["roi_cnt"])),
        ("IRFinder-ChrCoverage.txt", lambda fh: jfmt.write_chr_coverage(
            fh, jheader.ref_names, jfc["chr_frag"])),
    ):
        buf = io.StringIO()
        fn(buf)
        want[name] = buf.getvalue()
    assert got == want
    assert all(got.values()) and len(got["IRFinder-IR-nondir.txt"]) > 1000


def _assert_tabfmt_renders_as_jax(monkeypatch, tmp_path) -> None:
    """The port's formatter renders what the JAX package's renders, on 8
    cores so that tables of more than ROWS_PER_CHUNK rows split: every
    column kind, the %g and int64 edge values of tests/test_torch_tabfmt.py,
    an empty string and a pool of its own for each string column, at
    R - 1, R, R + 1 and 3R + 7 rows and with R lowered to 64.

    The one difference is a NaN with its sign bit set (x86 makes it for
    inf / inf): the JAX package's native formatter writes printf's "-nan",
    the port's writes "nan", as the JAX package's own format.py (the
    formatting spec, Python's f"{v:g}") does.

    The JAX package builds its library in place with make, where a build in
    another test process can leave it half written; its source is built
    here on its own, with its Makefile's flags."""
    from test_torch_tabfmt import G_EDGES, I_EDGES, _spread

    from irfinder_tpu.native import tabfmt as jtabfmt
    from irfinder_tpu_torch.native import tabfmt

    lib = str(tmp_path / "libtabfmt.so")
    subprocess.run(["g++", "-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared", "-o", lib,
                    os.path.join(ROOT, "native", "tabfmt", "tabfmt.cpp")], check=True)
    monkeypatch.setattr(jtabfmt, "ensure_built", lambda *a, **k: lib)
    monkeypatch.setattr(jtabfmt, "_lib", None)
    monkeypatch.setattr(jtabfmt, "_lib_failed", False)
    monkeypatch.setattr(tabfmt, "usable_cores", lambda: 8)
    r = tabfmt.ROWS_PER_CHUNK
    chroms = ["chr1", "chrX", "", "chrUn_KI270742v1"]
    names = ["", "GENE/ENSG00000123456/known-exon", "A/B/clean", "é/ü/anti-near"]
    for rows_per_chunk, n in [(r, r - 1), (r, r), (r, r + 1), (r, 3 * r + 7), (64, 3 * 64 + 7)]:
        monkeypatch.setattr(tabfmt, "ROWS_PER_CHUNK", rows_per_chunk)
        rng = np.random.default_rng(n)
        cols = [
            ("s", rng.integers(0, len(chroms), n).astype(np.int32), chroms),
            ("i", _spread(rng.integers(-(2**62), 2**62, n), I_EDGES, rng)),
            ("s", rng.integers(0, len(names), n).astype(np.int32), names),
            ("g", _spread(10.0 ** rng.uniform(-307, 307, n) * rng.choice([1, -1], n), G_EDGES, rng)),
            ("g", _spread(rng.random(n) * 1e6, G_EDGES, rng)),
        ]
        assert tabfmt.chunk_count(n) == min(8, -(-n // rows_per_chunk))
        assert tabfmt.format_table(cols) == jtabfmt.format_table(cols), (rows_per_chunk, n)

    neg_nan = np.array([np.copysign(np.nan, -1.0), 1.0])
    assert tabfmt.format_table([("g", neg_nan)]) == b"nan\n1\n"
    assert jfmt.fmt_float(float(neg_nan[0])) == "nan"


@pytest.mark.parametrize("component", ["oracle", "tabfmt", "trim", "winflat"])
def test_host_sources_are_copies(component, monkeypatch, tmp_path):
    """The port builds its own copy of each C++ component; it stays the JAX
    package's source byte for byte.  The decoder and the table formatter are
    the exceptions, held to the originals by behaviour: the decoder's parsing
    runs in its worker pool (tests/test_torch_bamdecode.py), and the
    formatter renders large tables in row chunks on threads of its own, and
    its bytes are the original's but for a NaN with its sign bit set (here
    and tests/test_torch_tabfmt.py)."""
    if component == "tabfmt":
        _assert_tabfmt_renders_as_jax(monkeypatch, tmp_path)
        return
    with open(os.path.join(ROOT, "irfinder_tpu_torch", "csrc", "host", f"{component}.cpp"), "rb") as fh:
        port = fh.read()
    with open(os.path.join(ROOT, "native", component, f"{component}.cpp"), "rb") as fh:
        assert port == fh.read()


def _astuples(exons) -> list:
    return [dataclasses.astuple(e) for e in exons]


@pytest.mark.parametrize("source", ["lines", "gz"])
def test_gtf_parser_matches_jax(source, tmp_path):
    from irfinder_tpu.refio import gtf as jgtf
    from irfinder_tpu_torch.refio import gtf

    from test_refcompile import TOY_GTF

    text = "#!comment line\n" + TOY_GTF + 'chr1\thavana\tgene\t1\t9\t.\t+\t.\tgene_id "g";\n'
    if source == "lines":
        got = list(gtf.iter_exons_lines(text.splitlines(keepends=True)))
        want = list(jgtf.iter_exons_lines(text.splitlines(keepends=True)))
    else:
        path = str(tmp_path / "toy.gtf.gz")
        with gzip.open(path, "wt") as fh:
            fh.write(text)
        got, want = list(gtf.iter_exons(path)), list(jgtf.iter_exons(path))
    assert len(got) == 10 and _astuples(got) == _astuples(want)
    assert got[0].start == 100 and got[0].end == 200


def _records(kind: str, bw) -> list:
    """Seeded BAM records of one kind through writer module ``bw``."""
    rng = np.random.default_rng({"pairs": 0, "singles": 1, "mapq0": 2, "secondary": 3}[kind])
    cigars = ["100M", "40M300N60M", "30M2I30M", "20M5D40M", "50M10S", "10M700N10M650N10M"]
    out = []
    for i in range(60):
        pos = int(rng.integers(0, 4000))
        cig = cigars[int(rng.integers(0, len(cigars)))]
        rev = bool(rng.integers(0, 2))
        rid = int(rng.integers(0, 2))
        if kind == "pairs":
            out += bw.make_pair(f"p{i}", rid, pos, cig, pos + int(rng.integers(50, 300)), "75M", reverse1=rev)
        elif kind == "singles":
            out.append(bw.make_single(f"s{i}", rid, pos, cig, reverse=rev))
        elif kind == "mapq0":
            out.append(bw.make_single(f"m{i}", rid, pos, cig, mapq=0))
        else:
            out.append(bw.make_single(f"x{i}", rid, pos, cig, flag_extra=0x100))
    return out


@pytest.mark.parametrize("kind", ["pairs", "singles", "mapq0", "secondary"])
def test_bamwrite_is_byte_identical(kind):
    from irfinder_tpu.io import bamwrite as jbw
    from irfinder_tpu_torch.io import bamwrite as bw

    bufs = []
    for mod in (bw, jbw):
        recs = _records(kind, mod)
        buf = io.BytesIO()
        mod.write_bam(buf, ["chr1", "chr2"], [5000, 5000], recs)
        bufs.append(buf.getvalue())
    assert len(bufs[0]) > 200 and bufs[0] == bufs[1]


@pytest.mark.parametrize("seed", [0, 17])
def test_read_header_and_iter_reads_match_jax(seed):
    from irfinder_tpu.io.bgzf import read_all
    from irfinder_tpu_torch.io import bgzf

    from test_oracle import random_bam_bytes

    raw = random_bam_bytes(seed=seed, n_frags=300)
    payload = b"".join(bgzf.iter_blocks(io.BytesIO(raw)))
    assert payload == read_all(io.BytesIO(raw))
    (h, off), (jh, joff) = bampy.read_header(memoryview(payload)), jbampy.read_header(memoryview(payload))
    assert off == joff and (h.text, h.ref_names, h.ref_lengths) == (jh.text, jh.ref_names, jh.ref_lengths)
    got, want = list(bampy.iter_reads(payload)), list(jbampy.iter_reads(payload))
    assert len(got) == len(want) > 300
    assert sum(r is None for r in got) > 10
    for a, b in zip(got, want):
        assert (a is None and b is None) or dataclasses.asdict(a) == dataclasses.asdict(b)


COUNTERS = ("depth", "start_cnt", "end_cnt", "exact_cnt", "span_hits", "roi_cnt")


@pytest.mark.parametrize("source", ["toy", "synth"])
def test_numpy_oracle_matches_jax_and_the_count_step(source, jref, pref, tmp_path):
    """The port's NumPy oracle against irfinder_tpu.oracle on the same
    decoded batches, and against the port's own count step (the Engine on
    the CPU runs count_step_plain) with its host junction join: on
    tests/test_oracle.py's toy map and random reads, and on the synthetic
    map with a realistic read mix (junctions on annotated introns)."""
    import torch

    from irfinder_tpu import oracle as joracle
    from irfinder_tpu.refio.compile import compile_reference as j_compile
    from irfinder_tpu_torch import oracle
    from irfinder_tpu_torch.engine import Engine
    from irfinder_tpu_torch.finalize import junction_counters
    from irfinder_tpu_torch.ops.step import finalize_device
    from irfinder_tpu_torch.refio.compile import compile_reference

    from test_oracle import CHROMS, ROIS, random_bam_bytes, toy_exons

    if source == "toy":
        raw = random_bam_bytes(seed=5, n_frags=600)
        ref = compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS)
        jref = j_compile(toy_exons(), chrom_order=CHROMS, rois=ROIS)
    else:
        bam = str(tmp_path / "x.bam")
        jbamgen.write_realistic_bam(bam, jref, n_pairs=500, seed=12, stranded=True)
        with open(bam, "rb") as fh:
            raw = fh.read()
        ref = pref
    idx = {c: i for i, c in enumerate(ref.chroms)}
    _, batches, _ = bampy.decode_bam(io.BytesIO(raw), idx, cap_frags=128)
    batches = list(batches)
    _, jbatches, _ = jbampy.decode_bam(io.BytesIO(raw), idx, cap_frags=128)
    assert len(batches) > 2

    oc = oracle.OracleCounters.create(ref)
    jc = joracle.OracleCounters.create(jref)
    for b in batches:
        oc.add_batch(b)
    for b in jbatches:
        jc.add_batch(b)
    for k in COUNTERS:
        np.testing.assert_array_equal(getattr(oc, k), getattr(jc, k), err_msg=k)
    assert oc.chr_frag == jc.chr_frag and oc.n_frags == jc.n_frags > 100
    assert oc.depth.sum() > 0 and oc.span_hits.sum() > 0 and oc.roi_cnt.sum() > 0
    if source == "synth":
        assert oc.exact_cnt.sum() > 100
    for mode in ("nondir", "dir"):
        rows = oracle.intron_rows(oc, mode=mode)
        assert len(rows) == ref.n_introns
        assert _astuples(rows) == _astuples(joracle.intron_rows(jc, mode=mode))

    eng = Engine(ref, device="cpu")
    eng.reset(n_refids=len(ref.chroms))
    eng.run_stream(iter(batches))
    fin = finalize_device(eng.dref, eng.counters)
    got = {k: fin[k].numpy().astype(np.int64) for k in ("depth", "span_hits", "roi_cnt")}
    got["start_cnt"], got["end_cnt"], got["exact_cnt"] = junction_counters(ref, eng.junc_tally)
    for k in COUNTERS:
        np.testing.assert_array_equal(np.asarray(got[k]).astype(np.int64), getattr(oc, k), err_msg=k)
    chr_frag = fin["chr_frag"].numpy()
    assert {i: int(v) for i, v in enumerate(chr_frag) if v} == oc.chr_frag
    assert int(fin["n_frags"]) == oc.n_frags
    assert isinstance(fin["depth"], torch.Tensor)


@pytest.mark.parametrize("mode,flip", [("nondir", False), ("dir", False), ("dir", True)])
@pytest.mark.parametrize("fn", ["intron_rows", "intron_rows_loop"])
def test_finalize_rows_match_jax(fn, mode, flip, jref, pref, tmp_path):
    """finalize.intron_rows (the vectorized join) and intron_rows_loop (the
    scalar reference join) against the JAX package's, on the NumPy oracle's
    counters of a stranded read mix: equal rows, field for field."""
    from irfinder_tpu import finalize as jfinalize
    from irfinder_tpu import oracle as joracle
    from irfinder_tpu_torch import finalize

    bam = str(tmp_path / "x.bam")
    jbamgen.write_realistic_bam(bam, jref, n_pairs=500, seed=13, stranded=True)
    idx = {c: i for i, c in enumerate(jref.chroms)}
    with open(bam, "rb") as fh:
        _, batches, _ = jbampy.decode_bam(fh, idx, cap_frags=256)
        jc = joracle.OracleCounters.create(jref)
        for b in batches:
            jc.add_batch(b)
    args = (jc.depth, jc.start_cnt, jc.end_cnt, jc.exact_cnt, jc.span_hits)
    got = getattr(finalize, fn)(pref, *args, mode=mode, flip_strand=flip)
    want = getattr(jfinalize, fn)(jref, *args, mode=mode, flip_strand=flip)
    assert len(got) == pref.n_introns and jc.exact_cnt.sum() > 0 and jc.depth.sum() > 0
    assert _astuples(got) == _astuples(want)


def test_bgzf_read_all_matches_jax(pref, tmp_path):
    """io/bgzf.read_all: every block of a BGZF file inflated, as the JAX
    package's."""
    from irfinder_tpu.io import bgzf as jbgzf
    from irfinder_tpu_torch.io import bgzf

    bam = str(tmp_path / "x.bam")
    bamgen.write_realistic_bam(bam, pref, n_pairs=300, seed=14)
    with open(bam, "rb") as a, open(bam, "rb") as b:
        got, want = bgzf.read_all(a), jbgzf.read_all(b)
    assert got[:4] == b"BAM\1" and got == want


def test_goldens_column_knobs_match_jax():
    from irfinder_tpu import goldens as jgoldens
    from irfinder_tpu_torch import goldens

    assert goldens.COLUMN_KNOBS == jgoldens.COLUMN_KNOBS
