"""A run with the timed path broken underneath comes out not correct: the
harness driven on the CPU at a small size (its look for a card skipped),
once for each fault a cell can have.  The cells run on one card, so no
exchange between cards can be left out.  chr21.longread runs one sample a
call: its traffic (long_reads) cannot run through run_multi_bam."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness as H
from portbench.tests.conftest import small_map

CELLS = ["chr21.paired", "grch38.paired", "chr21.longread"]
SOUND = [(c, spc) for c in CELLS for spc in (1, 2) if (c, spc) != ("chr21.longread", 2)]


def _run(cell, small, seed=2**31 + 5):
    if cell == "grch38.paired":
        small["config"]["map"] = small_map(genes=90, chromosomes=3)
    return H.run_cell(cell, seed, 0.3, False, time.perf_counter(), device="cpu",
                      overrides=small, log=lambda s: None)


def _state_unchanged(E, monkeypatch):
    monkeypatch.setattr(E, "count_step", lambda dref, counters, batch: None)


def _half_batch(E, monkeypatch):
    """Every other block and fragment of each batch left out."""
    orig = E.count_step

    def half(dref, counters, batch):
        b = {k: v.clone() for k, v in batch.items()}
        b["blk_chrom"][1::2] = -1
        b["frag_refid"][1::2] = -1
        b["frag_chrom"][1::2] = -1
        orig(dref, counters, b)

    monkeypatch.setattr(E, "count_step", half)


def _answer_altered(E, monkeypatch):
    """One boundary point's count off by one where the result is made."""
    orig = E.result_bundle

    def altered(ref, joined, fc, cache):
        out = orig(ref, joined, fc, cache)
        hits = out["counters"]["span_hits"].copy()
        hits[0, 0] += 1
        out["counters"]["span_hits"] = hits
        return out

    monkeypatch.setattr(E, "result_bundle", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("cell,spc", SOUND)
def test_sound_run_is_correct(cell, spc, small):
    """A sound run is correct, with one sample a call (run_bam) and with
    two (run_multi_bam, a traffic file of {"samples_per_call": 2})."""
    small["traffic"]["samples_per_call"] = spc
    r = _run(cell, small)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= spc
    assert r["attempted"] % spc == 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"} | (
        {"sample_s_p90"} if cell == "chr21.paired" and spc == 1 and r["attempted"] >= 10
        else set())


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, small, monkeypatch):
    import irfinder_tpu_torch.engine as E

    FAULTS[fault](E, monkeypatch)
    r = _run(cell, small)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def test_long_reads_need_one_sample_a_call(small):
    """A long-read traffic of several samples a call is refused when its
    spec loads: run_multi_bam takes no RunConfig."""
    small["traffic"]["samples_per_call"] = 2
    with pytest.raises(SystemExit, match="RunConfig"):
        _run("chr21.longread", small)


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "chr21.paired", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Without a card the run fails and prints no result (the CPU here)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(H.ROOT)
    assert out.returncode != 0 and "{" not in out.stdout


@pytest.mark.cuda
def test_card_run_is_correct(cuda_card):
    """On the card: one short run of the first cell, correct."""
    out = _run_py(H.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_benchmark_alone_fails(cuda_card, tmp_path):
    """On the card: a directory holding only BENCHMARK.json and the
    benchmark's folder cannot run (no program) and prints no result."""
    shutil.copy(os.path.join(H.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(H.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(str(tmp_path))
    assert out.returncode != 0 and "{" not in out.stdout
