"""The port's ``-m BAM`` path end to end against the JAX package's.

irfinder_tpu_torch.engine.run_bam (CPU tensors, plain ops) and
irfinder_tpu.engine.run_bam (CPU backend) count the same generated BAM; all
six tables and WARNINGS must be byte-identical and metrics.json equal on its
count fields (timings differ by nature).  The port gets each reference
converted from the JAX package's (convert.compiled_ref_from_numpy).
"""

import dataclasses
import json
import os
import threading

import pytest
import torch

from irfinder_tpu.config import RunConfig
from irfinder_tpu.engine import run_bam as jax_run_bam
from irfinder_tpu.io.bamgen import write_longread_bam, write_realistic_bam
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch import cli, conformance
from irfinder_tpu_torch.convert import compiled_ref_from_numpy
from irfinder_tpu_torch.engine import Engine, run_bam
from irfinder_tpu_torch.io.batch import PackedBatch

TABLES = (
    "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt", "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt", "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    "WARNINGS",
)
COUNT_FIELDS = (
    "reads_total", "reads_admitted", "fragments", "batches", "wire_bytes",
    "is_stranded", "flip_strand", "dir_concordance", "dir_informative",
)

#: case -> (BAM writer kwargs, RunConfig kwargs)
CASES = {
    "unstranded": (dict(n_pairs=2500, seed=1), dict(cap_frags=4096)),
    "stranded": (dict(n_pairs=6000, seed=2, stranded=True), dict(cap_frags=4096)),
    "long_reads": (dict(n_reads=400, seed=4), dict(cap_frags=256, long_reads=True)),
    "many_batches": (dict(n_pairs=2500, seed=3), dict(cap_frags=256)),
    "python_decoder": (dict(n_pairs=1500, seed=5), dict(cap_frags=1024, use_native=False)),
}


def port_ref(ref):
    """The port's CompiledRef of a JAX package reference, carried as data."""
    return compiled_ref_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})


@pytest.fixture(scope="module")
def refs():
    return {
        "one": synth_ref(n_genes=40),
        "three": synth_ref(n_genes=60, n_chroms=3, chrom_len=20_000_000, seed=2),
    }


@pytest.fixture(scope="module")
def prefs(refs):
    return {k: port_ref(r) for k, r in refs.items()}


def _read(d, name):
    with open(os.path.join(d, name), "rb") as fh:
        return fh.read()


def _assert_same_outputs(ours, theirs):
    for t in TABLES:
        assert _read(ours, t) == _read(theirs, t), t
    m_ours = json.loads(_read(ours, "metrics.json"))
    m_theirs = json.loads(_read(theirs, "metrics.json"))
    assert m_ours["device"] == "cpu"
    for k in COUNT_FIELDS:
        assert m_ours[k] == m_theirs[k], k


@pytest.mark.parametrize("case", list(CASES))
def test_run_bam_matches_jax(case, refs, prefs, tmp_path):
    from irfinder_tpu_torch.config import RunConfig as PortRunConfig

    bam_kw, cfg_kw = CASES[case]
    bam = str(tmp_path / "in.bam")
    name = "three" if case == "long_reads" else "one"
    ref = refs[name]
    if case == "long_reads":
        write_longread_bam(bam, ref, **bam_kw)
    else:
        write_realistic_bam(bam, ref, **bam_kw)
    m_jax = jax_run_bam(ref, bam, str(tmp_path / "jax"), config=RunConfig(**cfg_kw))
    m = run_bam(prefs[name], bam, str(tmp_path / "torch"), config=PortRunConfig(**cfg_kw),
                device="cpu")
    _assert_same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert m.batches == m_jax.batches
    if case == "stranded":
        assert m.is_stranded, "the stranded case must exercise the dir polarity path"
    if case == "many_batches":
        assert m.batches > 5
    if case == "long_reads":
        assert m.fragments == 400


def test_cli_bam(refs, tmp_path):
    """python -m irfinder_tpu_torch.cli BAM -r REF -d OUT x.bam, as the JAX CLI."""
    ref = refs["one"]
    ref_dir = str(tmp_path / "ref")
    ref.save(ref_dir)
    bam = str(tmp_path / "x.bam")
    write_realistic_bam(bam, ref, n_pairs=1500, seed=6)
    out = str(tmp_path / "cli")
    assert cli.main(
        ["BAM", "-r", ref_dir, "-d", out, "--cap-frags", "512", "--device", "cpu", bam]
    ) == 0
    jax_run_bam(ref, bam, str(tmp_path / "jax"), cap_frags=512)
    _assert_same_outputs(out, str(tmp_path / "jax"))
    # what is not ported exits non-zero instead of running something else
    assert cli.main(["Diff", "-a", out, "-b", out, "-d", str(tmp_path / "diff.txt")]) == 2
    assert not os.path.exists(tmp_path / "diff.txt")
    # --mesh runs the mesh (tests/test_torch_mesh.py holds its shapes)
    mesh = str(tmp_path / "mesh")
    assert cli.main(["BAM", "-r", ref_dir, "-d", mesh, "--mesh", "dp=2", "--cap-frags", "512",
                     "--device", "cpu", bam]) == 0
    for t in TABLES:
        assert _read(mesh, t) == _read(str(tmp_path / "jax"), t), t
    # a checkpointed run with no snapshot yet counts from the start and
    # leaves no snapshot behind
    ck = str(tmp_path / "ck.npz")
    again = str(tmp_path / "again")
    assert cli.main(["BAM", "-r", ref_dir, "-d", again, "--cap-frags", "512", "--checkpoint", ck,
                     "--device", "cpu", bam]) == 0
    assert not os.path.exists(ck)
    _assert_same_outputs(again, str(tmp_path / "jax"))


@pytest.mark.parametrize("fault", ["decoder_error", "wire_only_batch"])
def test_run_stream_surfaces_faults(fault, prefs):
    """A decoder error mid-stream, or a batch whose block/frag columns were
    never filled, raises on the caller's thread; the pipeline threads exit."""

    def batches():
        b = PackedBatch.empty(4096, 4096, 1024)
        yield b
        if fault == "decoder_error":
            raise ValueError("corrupt BGZF block")
        b2 = PackedBatch.empty(4096, 4096, 1024)
        b2.columns_full = False
        yield b2

    eng = Engine(prefs["one"], device="cpu")
    eng.reset(n_refids=1)
    before = threading.active_count()
    with pytest.raises(ValueError if fault == "decoder_error" else RuntimeError):
        eng.run_stream(batches())
    assert threading.active_count() == before
    assert eng.metrics.batches == 1


def test_conformance_oracle_matches_port(prefs, tmp_path):
    """The conformance helpers the card check uses: the C++ oracle's counters
    and the tables rendered from them equal the port's run on the CPU."""
    ref = prefs["one"]
    bam = str(tmp_path / "x.bam")
    conformance.write_realistic_bam(bam, ref, n_pairs=1500, seed=7)
    out = str(tmp_path / "torch")
    m = run_bam(ref, bam, out, cap_frags=512, device="cpu")
    assert conformance.native_decoder() == "native"
    fc, header, _, _ = conformance.oracle_run(ref, bam, 512)
    assert int(fc["n_frags"]) == m.fragments
    tables = conformance.oracle_tables(ref, header, fc)
    assert len(tables) == 5
    for name, text in tables.items():
        assert _read(out, name) == text.encode(), name


@pytest.mark.parametrize("entry", ["Engine", "run_bam", "run_bam_checkpoint", "cli_BAM", "cli_Batch",
                                   "cli_FastQ"])
def test_default_device_needs_a_card(entry, prefs, tmp_path):
    """The default device is the card: without one, every entry point fails
    instead of counting on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    ref = prefs["one"]
    bam = str(tmp_path / "x.bam")
    conformance.write_realistic_bam(bam, ref, n_pairs=200, seed=8)
    out = str(tmp_path / "out")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "Engine":
            Engine(ref)
        elif entry.startswith("run_bam"):
            ck = str(tmp_path / "ck.npz") if entry.endswith("checkpoint") else None
            run_bam(ref, bam, out, cap_frags=512, checkpoint=ck)
        else:
            ref_dir = str(tmp_path / "ref")
            ref.save(ref_dir)
            extra = ["--aligner-cmd", f"cat {bam}"] if entry == "cli_FastQ" else []
            cli.main([entry[4:], "-r", ref_dir, "-d", out, bam, *extra])
    assert not os.path.exists(os.path.join(out, "IRFinder-IR-nondir.txt"))
