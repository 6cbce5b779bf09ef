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
* csrc/host/*.cpp: byte-identical to native/*/*.cpp.
"""

import dataclasses
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


@pytest.mark.parametrize("component", ["bamdecode", "oracle", "tabfmt", "trim", "winflat"])
def test_host_sources_are_copies(component):
    """The port builds its own copy of each C++ component; it stays the JAX
    package's source byte for byte."""
    with open(os.path.join(ROOT, "irfinder_tpu_torch", "csrc", "host", f"{component}.cpp"), "rb") as fh:
        port = fh.read()
    with open(os.path.join(ROOT, "native", component, f"{component}.cpp"), "rb") as fh:
        assert port == fh.read()
