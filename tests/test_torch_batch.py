"""The port's batch mode (run_multi_bam, CLI ``Batch``) against the JAX
package's and against its own single-sample runs.

Each sample's six tables and WARNINGS must be byte-identical, metrics.json
equal on its count fields, and the pooled differential of ``Batch --a --b``
byte-identical to the JAX CLI's.
"""

import json
import os

import pytest

from irfinder_tpu import cli as jax_cli
from irfinder_tpu.engine import run_multi_bam as jax_run_multi_bam
from irfinder_tpu.io.bamgen import write_realistic_bam
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch import cli
from irfinder_tpu_torch.engine import run_bam, run_multi_bam

TABLES = (
    "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt", "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt", "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    "WARNINGS",
)
COUNT_FIELDS = (
    "reads_total", "reads_admitted", "fragments", "batches", "wire_bytes",
    "is_stranded", "flip_strand", "dir_concordance", "dir_informative",
)
#: sample -> write_realistic_bam kwargs (one stranded library among them)
SAMPLES = (
    dict(n_pairs=1500, seed=21),
    dict(n_pairs=6000, seed=2, stranded=True),
    dict(n_pairs=900, seed=23),
)


@pytest.fixture(scope="module")
def ref():
    return synth_ref(n_genes=40)


@pytest.fixture(scope="module")
def bams(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("bams")
    paths = []
    for i, kw in enumerate(SAMPLES):
        p = str(d / f"s{i}.bam")
        write_realistic_bam(p, ref, **kw)
        paths.append(p)
    return paths


def _read(d, name):
    with open(os.path.join(d, name), "rb") as fh:
        return fh.read()


def _metrics(d):
    return json.loads(_read(d, "metrics.json"))


def test_multi_bam_matches_jax(ref, bams, tmp_path):
    ours = [str(tmp_path / "torch" / f"s{i}") for i in range(len(bams))]
    theirs = [str(tmp_path / "jax" / f"s{i}") for i in range(len(bams))]
    ms = run_multi_bam(ref, bams, ours, cap_frags=512, device="cpu")
    jax_run_multi_bam(ref, bams, theirs, cap_frags=512)
    assert len(ms) == len(bams)
    for o, t in zip(ours, theirs):
        for name in TABLES:
            assert _read(o, name) == _read(t, name), (o, name)
        mo, mt = _metrics(o), _metrics(t)
        for k in COUNT_FIELDS:
            assert mo[k] == mt[k], (o, k)
        # the phase walls are on disk, not left at zero
        assert mo["multi_stream_s"] > 0 and mo["multi_finalize_s"] > 0
        assert mo["device"] == "cpu" and mo["batches"] > 1
    assert any(m.is_stranded for m in ms), "one sample must take the dir polarity path"


def test_multi_bam_matches_solo_runs(ref, bams, tmp_path):
    outs = [str(tmp_path / "multi" / f"s{i}") for i in range(len(bams))]
    ms = run_multi_bam(ref, bams, outs, cap_frags=256, device="cpu")
    for i, bam in enumerate(bams):
        solo = str(tmp_path / "solo" / f"s{i}")
        m = run_bam(ref, bam, solo, cap_frags=256, device="cpu")
        for name in TABLES:
            assert _read(outs[i], name) == _read(solo, name), (i, name)
        assert (ms[i].batches, ms[i].fragments) == (m.batches, m.fragments)


def test_cli_batch_differential_matches_jax(ref, bams, tmp_path):
    ref_dir = str(tmp_path / "ref")
    ref.save(ref_dir)
    args = ["Batch", "-r", ref_dir, "--a", "0,2", "--b", "1"]
    assert cli.main([*args, "-d", str(tmp_path / "torch"), "--device", "cpu", *bams]) == 0
    assert jax_cli.main([*args, "-d", str(tmp_path / "jax"), *bams]) == 0
    diff = _read(str(tmp_path / "torch"), "IRFinder-Diff.txt")
    assert diff and diff == _read(str(tmp_path / "jax"), "IRFinder-Diff.txt")
    for i in range(len(bams)):
        for name in TABLES:
            assert _read(str(tmp_path / "torch" / f"s{i}"), name) == \
                _read(str(tmp_path / "jax" / f"s{i}"), name), (i, name)


def test_multi_stream_stress_many_feeders(ref, bams):
    """More feeders than cores, with a short switch interval: every sample
    fed the same BAM ends with the counters of a solo stream (a lost or
    misrouted batch would break the equality)."""
    import sys
    import threading

    import torch

    from irfinder_tpu_torch.engine import Engine, open_decoder

    n = 2 * (os.cpu_count() or 4)
    eng = Engine(ref, device="cpu")
    header, batches, _ = open_decoder(ref, bams[0], 128, n_threads=1)
    eng.reset(n_refids=len(header.ref_names))
    eng.run_stream(batches)
    sts, streams = [], []
    for _ in range(n):
        header, batches, _ = open_decoder(ref, bams[0], 128, n_threads=1)
        st = eng.new_state(n_refids=len(header.ref_names))
        sts.append(st)
        streams.append((batches, st))
    before = threading.active_count()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        eng.run_multi_stream(streams)
    finally:
        sys.setswitchinterval(old)
    assert threading.active_count() == before
    for st in sts:
        assert st.metrics.batches == eng.metrics.batches > 10
        for k in ("cnt", "chr"):
            assert torch.equal(st.counters[k], eng.counters[k]), k


@pytest.mark.parametrize("fault", ["decoder_error", "wire_only_batch"])
def test_multi_stream_surfaces_faults(fault, ref):
    """A decoder error, or a batch whose columns were never filled, in one
    sample's feeder raises on the caller's thread; every feeder exits."""
    import threading

    from irfinder_tpu.io.batch import PackedBatch
    from irfinder_tpu_torch.engine import Engine

    def good():
        for _ in range(50):
            yield PackedBatch.empty(4096, 4096, 1024)

    def bad():
        yield PackedBatch.empty(4096, 4096, 1024)
        if fault == "decoder_error":
            raise ValueError("corrupt BGZF block")
        b = PackedBatch.empty(4096, 4096, 1024)
        b.columns_full = False
        yield b

    eng = Engine(ref, device="cpu")
    streams = [(good(), eng.new_state(1)), (bad(), eng.new_state(1))]
    before = threading.active_count()
    with pytest.raises(ValueError if fault == "decoder_error" else RuntimeError):
        eng.run_multi_stream(streams)
    assert threading.active_count() == before
