"""The cell chr21.cohort8: IRFinder's 4-vs-4 batch deployment, 8 samples a
run_multi_bam call on chr21's map.  Its files are found by name; a run
makes 8 inputs and 8 warm-ups from distinct seeds; a small CPU run is
correct and fills the three batch-mode readers, which read nothing in a
run of one sample a call; one sample's counters altered make the run not
correct."""

import json
import os
import time
import types

import pytest

from portbench import harness as H
from portbench import inputs, records

CELL = "chr21.cohort8"
READERS = ("batch.finish_share", "batch.finish.s_per_sample", "batch.stream.s_per_Mrec")


def _chr21():
    with open(os.path.join(H.ROOT, "portbench", "configs", "chr21.json")) as fh:
        return json.load(fh)


def _run(cell, small, monkeypatch, seed=2**32 + 977):
    """A small CPU run of ``cell``; returns (result, the Run its readers
    were handed)."""
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


def test_spec():
    """8 samples a call, one card, and the three batch-mode metrics as the
    cell's per-layer metrics.  (That its configuration is chr21's map and
    depth is held in tests/test_torch_cohort.py.)"""
    spec = H.load_spec(CELL)
    assert spec.traffic["samples_per_call"] == 8
    assert spec.cell["chips"] == 1 and spec.config["reduced"] == []
    assert spec.traffic["source"] and spec.traffic["deployment"] and spec.traffic["assumed"]
    assert {m["name"] for m in spec.per_layer} == set(READERS)
    assert {m["name"] for m in spec.end_to_end} == {"reads_per_s", "setup_s"}


def test_cohort_takes_the_batched_finalize():
    """The cohort's depth rows (2 x 8 samples x chr21's measured bases x 4
    bytes) fit MULTI_STATS_BUDGET: one intron_stats launch takes every
    sample of a call."""
    from irfinder_tpu_torch import engine as E

    n = H.load_spec(CELL).traffic["samples_per_call"]
    assert 2 * n * _chr21()["map_sizes"]["measured_bases"] * 4 <= E.MULTI_STATS_BUDGET


def test_inputs_from_distinct_seeds(tmp_path, small, monkeypatch):
    """8 inputs and 8 warm-ups, each from its own seed, each file its own."""
    from portbench import genome

    seeds = []
    orig = records.write_bam

    def spy(path, ref, pairs, seed):
        seeds.append(seed)
        return orig(path, ref, pairs, seed)

    monkeypatch.setattr(records, "write_bam", spy)
    spec = H.load_spec(CELL, small)
    ref = genome.make_map(spec.config["map"])
    got, warm = inputs.make_inputs(str(tmp_path), ref, spec.config, spec.traffic, 2**33 + 5)
    assert len(got) == len(warm) == 8 and len(set(seeds)) == 16
    assert all(i.records > 2 * 3000 for i in got) and all(w.records < 2 * 3000 for w in warm)
    blobs = set()
    for i in got + warm:
        with open(i.path, "rb") as fh:
            blobs.add(fh.read())
    assert len(blobs) == 16


def test_small_run_is_correct(small, monkeypatch):
    """A small CPU run of the cell: every sample of every call correct, each
    call's samples counted and finalized together, and the three readers
    filled."""
    r, run = _run(CELL, small, monkeypatch)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 8 and r["attempted"] % 8 == 0
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    for c in run.calls:
        assert [m.sample for m in c.metrics] == list(range(8))
        assert all(m.batch_samples == 8 and m.stats_batched for m in c.metrics)
        assert len({m.spans["batch"] for m in c.metrics}) == 1
    got = {n: H.reader(n)(run) for n in READERS}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["batch.finish_share"] < 100.0
    calls = [c.metrics[0].spans for c in run.calls]
    assert got["batch.finish.s_per_sample"] == pytest.approx(
        sum(s["batch.finish"] for s in calls) / (8 * len(calls)))


def test_one_sample_altered_is_not_correct(small, monkeypatch):
    """One boundary point's count of the fourth sample off by one where its
    result is made: the run is not correct, by SpansPoint alone."""
    from irfinder_tpu_torch import engine as E

    orig = E.Engine.results_multi_async

    def altered(self, sts):
        finishes = orig(self, sts)

        def fourth():
            out = finishes[3]()
            hits = out["counters"]["span_hits"].copy()
            hits[0, 0] += 1
            out["counters"]["span_hits"] = hits
            return out

        return finishes[:3] + [fourth] + finishes[4:]

    monkeypatch.setattr(E.Engine, "results_multi_async", altered)
    r, _ = _run(CELL, small, monkeypatch)
    assert not r["correct"] and r["failed"] == 0
    bad = {k for k, c in r["checks"].items() if c["value"] > c["limit"]}
    assert bad == {"spans_point_lines"}
    assert r["checks"]["spans_point_lines"]["value"] == r["attempted"] // 8


def test_readers_read_nothing_without_a_batch(small, monkeypatch):
    """In a run of one sample a call (run_bam), and on samples whose program
    records no ``batch`` span, the three readers give None."""
    _, run = _run("chr21.paired", small, monkeypatch)
    for n in READERS:
        assert H.reader(n)(run) is None, n
    bare = types.SimpleNamespace(spans={"stream": 1.0, "batch.finalize": 0.5})
    old = types.SimpleNamespace(
        calls=[types.SimpleNamespace(metrics=[bare, bare], inputs=[0, 1]),
               types.SimpleNamespace(metrics=None, inputs=[0, 1])],
        inputs=[types.SimpleNamespace(records=10)] * 2)
    for n in READERS:
        assert H.reader(n)(old) is None, n
