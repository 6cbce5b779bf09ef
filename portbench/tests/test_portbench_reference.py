"""The benchmark's plain reference (portbench/reference/) gives the port's
tables, byte for byte, for the benchmark's records (one sample a call and
two), and for a stranded library, at small sizes on the CPU; its integer
renderer is the per-line format; its float32 control fails."""

import dataclasses
import os

import numpy as np
import pytest

from portbench import genome, records
from portbench import reference as R
from portbench.frozen import bamgen
from portbench.harness import lines_differ
from portbench.reference import tables
from portbench.tests.conftest import small_map as small_params


@pytest.fixture(scope="module")
def small_map():
    return genome.make_map(small_params())


def _port_ref(ref):
    from irfinder_tpu_torch.convert import compiled_ref_from_numpy

    return compiled_ref_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})


def _read(out_dir):
    return {k: open(os.path.join(out_dir, k)).read() for k in R.TABLES}


@pytest.mark.parametrize("kind", ["records", "stranded"])
def test_reference_equals_port_run_bam(tmp_path, small_map, kind):
    from irfinder_tpu_torch.engine import run_bam

    bam = str(tmp_path / "x.bam")
    if kind == "records":
        records.write_bam(bam, small_map, 6000, seed=3)
    else:
        bamgen.write_realistic_bam(bam, small_map, 6000, seed=3, stranded=True)
    run_bam(_port_ref(small_map), bam, str(tmp_path / "out"), device="cpu")
    assert _read(str(tmp_path / "out")) == R.sample_tables(small_map, bam)


@pytest.mark.parametrize("long_reads", [True, False])
def test_reference_equals_port_long_reads(tmp_path, small_map, long_reads):
    """Long reads (reads/longread.py) through run_bam in the port's
    long-read geometry and in its default one."""
    import json

    from irfinder_tpu_torch.config import RunConfig
    from irfinder_tpu_torch.engine import run_bam
    from portbench.harness import HERE
    from portbench.reads import longread

    with open(os.path.join(HERE, "traffic", "longread.json")) as fh:
        tr = {**json.load(fh), "reads_per_sample": 2500}
    bam = str(tmp_path / "x.bam")
    longread.write_bam(bam, small_map, {"map": small_params()}, tr, seed=2**33 + 1)
    run_bam(_port_ref(small_map), bam, str(tmp_path / "out"),
            config=RunConfig(long_reads=long_reads), device="cpu")
    assert _read(str(tmp_path / "out")) == R.sample_tables(small_map, bam)


def test_reference_equals_port_multi_bam(tmp_path):
    """A 2-sample cohort through run_multi_bam, on a map of several
    chromosomes."""
    from irfinder_tpu_torch.engine import run_multi_bam

    ref = genome.make_map(small_params(genes=90, chromosomes=3))
    bams = [str(tmp_path / f"{i}.bam") for i in range(2)]
    for i, b in enumerate(bams):
        records.write_bam(b, ref, 4000, seed=11 + i)
    outs = [str(tmp_path / f"out{i}") for i in range(2)]
    run_multi_bam(_port_ref(ref), bams, outs, device="cpu")
    for b, o in zip(bams, outs):
        assert _read(o) == R.sample_tables(ref, b)


def test_int_renderer_is_the_line_format():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 3, 500)
    cols = [rng.integers(0, 10 ** rng.integers(1, 12), 500) for _ in range(4)]
    cols[1][:5] = 0
    labels = ["chr1", "x", "chr21.17"]
    want = "H\n" + "".join(
        f"{labels[i]}\t{a}\t{b}\t{c}\t{d}\n" for i, a, b, c, d in zip(idx, *cols))
    assert tables.render_int_table("H\n", labels, idx, cols) == want
    assert tables.render_int_table("H\n", labels, idx[:0], [c[:0] for c in cols]) == "H\n"


def test_control_fails(tmp_path, small_map):
    """The reference in float32 in the program's place differs from the
    reference in IR-table lines (the control of the check)."""
    from portbench.control import control_checks

    bam = str(tmp_path / "x.bam")
    records.write_bam(bam, small_map, 6000, seed=4)
    c = control_checks(small_map, bam)
    assert c["ir_nondir_lines"] > 0 and c["ir_dir_lines"] > 0
    assert c["junc_count_lines"] == 0 and c["spans_point_lines"] == 0


def test_lines_differ():
    assert lines_differ(b"a\nb\nc\n", b"a\nb\nc\n") == 0
    assert lines_differ(b"a\nx\nc\n", b"a\nb\nc\n") == 1
    assert lines_differ(b"a\nb\n", b"a\nb\nc\n") == 1
    assert lines_differ(b"a\nb", b"a\nb\n") == 1
