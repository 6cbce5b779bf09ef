"""The port's FastQ mode and its pipe path against BAM mode and the JAX
package.

FastQ mode runs an external aligner and counts its stdout.  A stand-in
aligner script records its arguments and cats a premade BAM: spooled,
``--stream`` and ``--stream --keep-bam`` must give tables byte-identical to
BAM mode and to the JAX CLI's FastQ, and the teed Unsorted.bam must be the
aligner's bytes.  ``run_bam`` on a pipe (os.pipe, ``cat x.bam |``, either
decoder, with and without the tee) equals the run on the path and the JAX
package's.  ``--trim`` runs the port's own trim filter, whose library
equals the JAX package's on random reads.
"""

import dataclasses
import os
import stat
import subprocess
import threading

import numpy as np
import pytest

from irfinder_tpu.cli import main as jax_main
from irfinder_tpu.engine import run_bam as jax_run_bam
from irfinder_tpu.io.bamgen import write_realistic_bam
from irfinder_tpu.native import trim_native as jtrim
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch import cli
from irfinder_tpu_torch.convert import compiled_ref_from_numpy
from irfinder_tpu_torch.engine import run_bam
from irfinder_tpu_torch.native import trim_native

TABLES = (
    "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt", "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt", "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    "WARNINGS",
)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(port ref, ref dir, BAM path, JAX package's BAM-mode output dir)."""
    d = tmp_path_factory.mktemp("fastq")
    ref = synth_ref(n_genes=40)
    ref.save(str(d / "REF"))
    bam = str(d / "aligned.bam")
    write_realistic_bam(bam, ref, n_pairs=2000, seed=11)
    jax_run_bam(ref, bam, str(d / "jax_bam"))
    pref = compiled_ref_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})
    return pref, str(d / "REF"), bam, str(d / "jax_bam")


def read(path) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def assert_same_tables(a, b):
    for t in TABLES:
        assert read(os.path.join(a, t)) == read(os.path.join(b, t)), t


def write_fastq(path, n=5):
    with open(path, "w") as fh:
        for i in range(n):
            fh.write(f"@r{i}\nACGTACGTAC\n+\nIIIIIIIIII\n")


def stand_in_aligner(d, bam, record) -> str:
    """A script that writes its two arguments to ``record`` and cats
    ``bam`` to stdout."""
    fake = os.path.join(d, "fake_aligner.sh")
    with open(fake, "w") as fh:
        fh.write(f'#!/bin/sh\necho "$1 $2" > {record}\ncat {bam}\n')
    os.chmod(fake, os.stat(fake).st_mode | stat.S_IEXEC)
    return fake


@pytest.mark.parametrize("mode", ["spooled", "stream", "stream_keep_bam"])
def test_fastq_matches_bam_mode_and_jax(mode, setup, tmp_path):
    _, ref_dir, bam, jax_bam = setup
    r1, r2 = str(tmp_path / "r_1.fq"), str(tmp_path / "r_2.fq")
    write_fastq(r1)
    write_fastq(r2)
    flags = {"spooled": [], "stream": ["--stream"], "stream_keep_bam": ["--stream", "--keep-bam"]}[mode]
    outs = {}
    for pkg, main in (("port", cli.main), ("jax", jax_main)):
        record = str(tmp_path / f"args_{pkg}")
        fake = stand_in_aligner(str(tmp_path), bam, record)
        outs[pkg] = str(tmp_path / pkg)
        argv = ["FastQ", "-r", ref_dir, "-d", outs[pkg], r1, r2, "--aligner-cmd", f"{fake} {{r1}} {{r2}}",
                *flags] + (["--device", "cpu"] if pkg == "port" else [])
        assert main(argv) == 0
        assert read(record).decode().split() == [r1, r2]
    bam_mode = str(tmp_path / "bam_mode")
    assert cli.main(["BAM", "-r", ref_dir, "-d", bam_mode, "--device", "cpu", bam]) == 0
    assert_same_tables(outs["port"], bam_mode)
    assert_same_tables(outs["port"], outs["jax"])
    assert_same_tables(outs["port"], jax_bam)
    spool = os.path.join(outs["port"], "Unsorted.bam")
    assert os.path.exists(spool) == (mode == "stream_keep_bam")
    if mode == "stream_keep_bam":
        assert read(spool) == read(bam)


def test_fastq_requires_aligner_cmd(setup, tmp_path):
    _, ref_dir, _, _ = setup
    r1 = str(tmp_path / "r.fq")
    write_fastq(r1)
    assert cli.main(["FastQ", "-r", ref_dir, "-d", str(tmp_path / "o"), r1, "--device", "cpu"]) == 2


def test_fastq_trim_clips_the_adapter(setup, tmp_path):
    """--trim runs the port's trim filter; the trimmed FASTQs feed the
    aligner and equal the JAX CLI's byte for byte."""
    _, ref_dir, bam, jax_bam = setup
    r1, r2 = str(tmp_path / "t_1.fq"), str(tmp_path / "t_2.fq")
    seq = "ACGTACGTAC" + trim_native.ADAPTER_R1.decode()
    with open(r1, "w") as fh:
        fh.write(f"@a0\n{seq}\n+\n{'I' * len(seq)}\n@a1\nGGGGCCCCAAAATTTT\n+\n{'I' * 16}\n")
    with open(r2, "w") as fh:
        fh.write(f"@a0\nTTTTGGGGCC\n+\nIIIIIIIIII\n@a1\nCCCCAAAAGGGGTTTT\n+\n{'I' * 16}\n")
    outs = {}
    for pkg, main in (("port", cli.main), ("jax", jax_main)):
        record = str(tmp_path / f"args_{pkg}")
        fake = stand_in_aligner(str(tmp_path), bam, record)
        outs[pkg] = str(tmp_path / pkg)
        argv = ["FastQ", "-r", ref_dir, "-d", outs[pkg], r1, r2, "--trim",
                "--aligner-cmd", f"{fake} {{r1}} {{r2}}"] + (["--device", "cpu"] if pkg == "port" else [])
        assert main(argv) == 0
        assert read(record).decode().split() == [
            os.path.join(outs[pkg], "trimmed_1.fastq"), os.path.join(outs[pkg], "trimmed_2.fastq")]
    lines = read(os.path.join(outs["port"], "trimmed_1.fastq")).decode().splitlines()
    assert lines[1] == "ACGTACGTAC", "adapter suffix not clipped"
    assert lines[5] == "GGGGCCCCAAAATTTT"
    for name in ("trimmed_1.fastq", "trimmed_2.fastq"):
        assert read(os.path.join(outs["port"], name)) == read(os.path.join(outs["jax"], name)), name
    assert_same_tables(outs["port"], jax_bam)


def test_trim_library_matches_jax():
    """trim1 and trim_pair of the port's library equal the JAX package's on
    random reads, some carrying adapters, some with read-through."""
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def rand_seq(n):
        return bases[rng.integers(0, 4, n)].tobytes()

    n_cut = 0
    for i in range(300):
        insert = rand_seq(int(rng.integers(5, 80)))
        r1 = insert + trim_native.ADAPTER_R1[: int(rng.integers(0, 34))] if i % 2 else insert
        r2 = insert[::-1] + trim_native.ADAPTER_R2[: int(rng.integers(0, 34))] if i % 3 else rand_seq(60)
        got, want = trim_native.trim1(r1), jtrim.trim1(r1)
        assert got == want
        n_cut += got < len(r1)
        assert trim_native.trim_pair(r1, r2) == jtrim.trim_pair(r1, r2)
    assert n_cut > 50


def test_trim_binary_is_built_in_the_port():
    path = trim_native.trim_binary()
    assert os.path.dirname(path).endswith(os.path.join("irfinder_tpu_torch", "_build"))
    assert os.access(path, os.X_OK) and trim_native.trim_binary() == path


@pytest.mark.parametrize("source", ["os_pipe", "cat", "cat_python_decoder", "tee_native", "tee_python"])
def test_run_bam_on_a_pipe(source, setup, tmp_path):
    """run_bam counting off a pipe equals the run on the path and the JAX
    package's; a teed copy is the stream's bytes exactly once."""
    pref, _, bam, jax_bam = setup
    on_path = str(tmp_path / "path")
    run_bam(pref, bam, on_path, device="cpu")
    out = str(tmp_path / "pipe")
    native = "python" not in source
    if source == "os_pipe":
        r, w = os.pipe()
        data = read(bam)

        def writer():
            with os.fdopen(w, "wb") as fh:
                fh.write(data)

        t = threading.Thread(target=writer)
        t.start()
        with os.fdopen(r, "rb") as src:
            run_bam(pref, src, out, device="cpu")
        t.join(timeout=60)
        assert not t.is_alive()
    else:
        p = subprocess.Popen(["cat", bam], stdout=subprocess.PIPE)
        try:
            src = p.stdout
            if source.startswith("tee"):
                src = cli._TeeReader(p.stdout, open(str(tmp_path / "Unsorted.bam"), "wb"))
            try:
                run_bam(pref, src, out, use_native=native, device="cpu")
            finally:
                if source.startswith("tee"):
                    src.close_sink()
        finally:
            p.stdout.close()
            assert p.wait(timeout=60) == 0
        if source.startswith("tee"):
            assert read(str(tmp_path / "Unsorted.bam")) == read(bam)
    assert_same_tables(out, on_path)
    assert_same_tables(out, jax_bam)
