"""Batch mode's cohort (run_multi_bam, BASELINE config D) against the
benchmark's plain reference (portbench/reference/), on the CPU.

Eight samples of the benchmark's STAR-shaped records, each from its own
seed, on a cut of the chr21 map, counted together in one run_multi_bam
call: every sample's six tables and WARNINGS must equal the reference's
tables of that sample's own BAM, byte for byte, whether one intron_stats
launch takes every sample (the batched finalize) or the samples finalize
one at a time (past MULTI_STATS_BUDGET), and for a cohort of two.
"""

import dataclasses
import json
import os

import pytest

from irfinder_tpu_torch import engine as E
from irfinder_tpu_torch.convert import compiled_ref_from_numpy
from portbench import genome, records
from portbench import reference as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = tuple(2**32 + 101 * k for k in range(8))
PAIRS = 2500


@pytest.fixture(scope="module")
def ref():
    """chr21's map parameters at 60 genes."""
    with open(os.path.join(ROOT, "portbench", "configs", "chr21.json")) as fh:
        params = json.load(fh)["map"]
    params["genes"] = 60
    return genome.make_map(params)


@pytest.fixture(scope="module")
def pref(ref):
    return compiled_ref_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})


@pytest.fixture(scope="module")
def cohort(ref, tmp_path_factory):
    """(BAM path, the reference's tables of it) of each of 8 samples."""
    d = tmp_path_factory.mktemp("cohort")
    out = []
    for i, seed in enumerate(SEEDS):
        path = str(d / f"s{i}.bam")
        records.write_bam(path, ref, PAIRS, seed)
        out.append((path, R.sample_tables(ref, path)))
    return out


@pytest.mark.parametrize("n,batched", [(8, True), (8, False), (2, True)],
                         ids=["batched", "one_at_a_time", "pair"])
def test_cohort_equals_the_reference(pref, cohort, tmp_path, monkeypatch, n, batched):
    if not batched:
        monkeypatch.setattr(E, "MULTI_STATS_BUDGET", 0)
    bams = [p for p, _ in cohort[:n]]
    outs = [str(tmp_path / f"out{i}") for i in range(n)]
    ms = E.run_multi_bam(pref, bams, outs, device="cpu")
    assert [m.sample for m in ms] == list(range(n))
    assert all(m.batch_samples == n and m.stats_batched is batched for m in ms)
    for (_, want), out in zip(cohort, outs):
        for name, text in want.items():
            with open(os.path.join(out, name), "rb") as fh:
                assert fh.read() == text.encode(), (out, name)


def test_cohort_configuration_is_chr21s():
    """The benchmark's cohort configuration is chr21's map and sample depth
    with chr21's guarantees and one more: its file copies chr21.json's
    (the harness reads a configuration's own file), which the cohort above
    is cut from."""
    cfgs = {}
    for name in ("chr21", "chr21_cohort8"):
        with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as fh:
            cfgs[name] = json.load(fh)
    chr21, cohort = cfgs["chr21"], cfgs["chr21_cohort8"]
    for k in ("map", "pairs_per_sample"):
        assert cohort[k] == chr21[k], k
    assert set(chr21["guarantees"].items()) < set(cohort["guarantees"].items())
