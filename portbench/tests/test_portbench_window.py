"""grch38.paired keeps its throughput as a per-layer metric: its runs on one
card spread too widely for reads_per_s's end-to-end bound, so the cell
reports window.reads_per_s, the same reading held to nothing, beside
device_peak_GB and setup_s.  stage.s_per_Mrec reads run_bam's staging in
chr21.paired, the one-card counterpart of the mesh's four stagings a
batch."""

import time

import pytest

from portbench import harness as H
from portbench.tests.conftest import small_map


def _run(cell, small, monkeypatch, seed=2**31 + 77):
    """A small CPU run of ``cell``; returns (result, the Run its readers
    were handed)."""
    if cell == "grch38.paired":
        small["config"]["map"] = small_map(genes=90, chromosomes=3)
    seen = {}
    orig = H.reader

    def spy(name):
        read = orig(name)

        def keep(run):
            seen["run"] = run
            return read(run)

        return keep

    monkeypatch.setattr(H, "reader", spy)
    r = H.run_cell(cell, seed, 0.3, False, time.perf_counter(), device="cpu",
                   overrides=small, log=lambda s: None)
    return r, seen["run"]


def test_grch38_paired_spec():
    """reads_per_s is no end-to-end metric of grch38.paired, whose only
    per-layer metric is window.reads_per_s, moving device_peak_GB; every
    other cell keeps reads_per_s end to end."""
    spec = H.load_spec("grch38.paired")
    assert {m["name"] for m in spec.end_to_end} == {"device_peak_GB", "setup_s"}
    assert [(m["name"], m["moves"]) for m in spec.per_layer] == [
        ("window.reads_per_s", "device_peak_GB")]
    for cell in ("chr21.paired", "chr21.longread", "chr21.cohort8", "grch38.mesh_dp4"):
        assert "reads_per_s" in {m["name"] for m in H.load_spec(cell).end_to_end}, cell


def test_window_reads_per_s_is_reads_per_s(small, monkeypatch):
    """On a correct grch38.paired run, window.reads_per_s reads what
    reads_per_s reads: all records of the window's samples over its time."""
    r, run = _run("grch38.paired", small, monkeypatch)
    assert r["correct"] and r["attempted"] >= 1
    got = H.reader("window.reads_per_s")(run)
    assert got is not None and got > 0
    assert got == H.reader("reads_per_s")(run)
    records = sum(run.inputs[i].records for i, _ in run.completed)
    assert got == pytest.approx(records / (run.t_end - run.t_start))


def test_stage_in_chr21_paired(small, monkeypatch):
    """chr21.paired lists stage.s_per_Mrec, and run_bam's stage span fills
    it: Σ stage over Σ records, per million."""
    assert "stage.s_per_Mrec" in {m["name"] for m in H.load_spec("chr21.paired").per_layer}
    r, run = _run("chr21.paired", small, monkeypatch)
    assert r["correct"]
    got = H.reader("stage.s_per_Mrec")(run)
    records = sum(run.inputs[i].records for i, _ in run.completed)
    assert got is not None and got > 0
    assert got == pytest.approx(sum(m.spans["stage"] for _, m in run.completed) / records * 1e6)
