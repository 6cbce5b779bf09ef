"""The port's spans (irfinder_tpu_torch/spans.py) on the CPU.

A run's phases land in RunMetrics.spans always, and in a torch.profiler
trace as ``irf.<name>`` ranges while a profiler records: nested in the
caller's range, in the order run_bam runs them, each as long as its span.
With no profiler, no range is opened.  Batch mode adds the call's spans
``batch`` and ``batch.finish`` and, under both entry points, the counters
batch_samples, stats_batched and decoder_threads.  The benchmark's readers
of the spans give finite numbers on a real run, and nothing on metrics
without spans.
"""

import json
import math
import os
import sys
import threading
import time
import types
from collections import defaultdict

import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from irfinder_tpu_torch import cli
from irfinder_tpu_torch import spans as S
from irfinder_tpu_torch.conformance import synth_ref, write_realistic_bam
from irfinder_tpu_torch.engine import RunMetrics, run_bam, run_multi_bam
from irfinder_tpu_torch.engine_mesh import MeshSpec, run_bam_mesh
from portbench.harness import reader

TABLES = ("JuncCount", "IR-nondir", "IR-dir", "SpansPoint", "ROI", "ChrCoverage", "WARNINGS")
WRITES = tuple("write." + t for t in TABLES) + ("write.metrics",)
TOP = ("open", "stream", "finalize") + WRITES
READERS = ("write.s_per_sample", "junctions.s_per_sample", "stream.wait_share", "open.s_per_sample")
BATCH_READERS = ("batch.finish_share", "batch.finish.s_per_sample", "batch.stream.s_per_Mrec")


@pytest.fixture(scope="module")
def ref():
    return synth_ref(n_genes=8, chrom_len=1_000_000)


@pytest.fixture(scope="module")
def bams(ref, tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    out = []
    for i, n in enumerate((1500, 1000)):
        path = str(d / f"s{i}.bam")
        write_realistic_bam(path, ref, n_pairs=n, seed=i)
        out.append(path)
    return out


def _ranges(trace_path: str) -> list:
    """(name less ``irf.``, start us, end us, thread) of every irf. range."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    return [(e["name"][len(S.PREFIX):], e["ts"], e["ts"] + e["dur"], e["tid"]) for e in events
            if e.get("ph") == "X" and e.get("name", "").startswith(S.PREFIX)]


def test_profiled_run_bam_has_every_range(ref, bams, tmp_path):
    """Under a profiler, run_bam's phases are irf. ranges on the calling
    thread, nested in the caller's range: open, then stream, then the
    finalize's launch, the JuncCount write, its finish and every other
    table's write; each name's ranges last as long as its span."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("test.outer"):
            m = run_bam(ref, bams[0], str(tmp_path / "out"), cap_frags=256, device="cpu")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        outer = [e for e in json.load(fh)["traceEvents"] if e.get("name") == "test.outer"]
    assert len(outer) == 1
    o0, o1, tid = outer[0]["ts"], outer[0]["ts"] + outer[0]["dur"], outer[0]["tid"]
    main = [r for r in _ranges(path) if r[3] == tid]
    assert all(o0 <= s and e <= o1 for _, s, e, _ in main)
    by_name = defaultdict(list)
    for name, s, e, _ in sorted(main, key=lambda r: r[1]):
        by_name[name].append((s, e))
    for name in TOP:
        assert by_name[name], name
    assert len(by_name["open"]) == len(by_name["stream"]) == 1
    assert len(by_name["finalize"]) == 2  # the launch, then the finish
    (op,), (st,) = by_name["open"], by_name["stream"]
    launch, finish = by_name["finalize"]
    (junc,) = by_name["write.JuncCount"]
    assert op[1] <= st[0] and st[1] <= launch[0]
    assert launch[1] <= junc[0] and junc[1] <= finish[0]
    for name in WRITES[1:]:
        assert by_name[name][0][0] >= finish[1], name
    for name, rs in by_name.items():
        got = sum(e - s for s, e in rs) / 1e6
        assert abs(got - m.spans[name]) <= max(0.1 * m.spans[name], 1e-3), (name, got, m.spans[name])


def test_without_profiler_no_range_is_opened(ref, bams, tmp_path, monkeypatch):
    """With no profiler recording, a span never enters record_function, and
    the spans and the fields they fill are still taken."""

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(S._profiler, "record_function", refuse)
    m = run_bam(ref, bams[0], str(tmp_path / "out"), cap_frags=256, device="cpu")
    for name in TOP + ("count", "junctions.tally", "junctions.merge", "junctions.join", "decode", "stage"):
        assert m.spans.get(name, 0.0) > 0, name
    assert m.decode_s == m.spans["decode"]
    assert m.finalize_s == m.spans["finalize"]


def test_counters_at_the_span_boundaries(ref, bams, tmp_path):
    """table_bytes is the bytes of the six tables and WARNINGS, and
    junctions_distinct the JuncCount table's rows."""
    out = str(tmp_path / "out")
    m = run_bam(ref, bams[0], out, cap_frags=256, device="cpu")
    names = [("IRFinder-" + t + ".txt") if t != "WARNINGS" else t for t in TABLES]
    assert m.table_bytes == sum(os.path.getsize(os.path.join(out, n)) for n in names)
    with open(os.path.join(out, "IRFinder-JuncCount.txt")) as fh:
        assert m.junctions_distinct == sum(1 for _ in fh) - 1 > 0
    with open(os.path.join(out, "metrics.json")) as fh:
        saved = json.load(fh)
    assert saved["spans"]["stream"] == m.spans["stream"]
    assert saved["table_bytes"] == m.table_bytes and saved["stream_waits"] == m.stream_waits
    for gone in ("device_s", "h2d_s", "sync_s", "route_s"):
        assert gone not in saved


def test_top_level_spans_within_the_wall(ref, bams, tmp_path):
    """run_bam's top-level spans do not overlap: their sum is at most the
    call's wall."""
    t0 = time.perf_counter()
    m = run_bam(ref, bams[0], str(tmp_path / "out"), cap_frags=256, device="cpu")
    wall = time.perf_counter() - t0
    assert 0 < sum(m.spans[k] for k in TOP) <= wall


def test_multi_bam_spans(ref, bams, tmp_path):
    """Batch mode: every sample has its spans and its index; the stream's
    wait is within the stream, which is multi_stream_s on every sample."""
    ms = run_multi_bam(ref, bams, [str(tmp_path / f"b{i}") for i in range(2)], cap_frags=256, device="cpu")
    assert [m.sample for m in ms] == [0, 1]
    for m in ms:
        for name in TOP + ("count", "junctions.tally", "junctions.join", "decode", "batch.finalize"):
            assert m.spans.get(name, 0.0) > 0, (m.sample, name)
        assert m.spans.get("stream.wait", 0.0) <= m.spans["stream"]
        assert m.multi_stream_s == m.spans["stream"] == ms[0].spans["stream"]
        assert m.multi_finalize_s == m.spans["batch.finalize"]


def test_batch_spans(ref, bams, tmp_path):
    """Batch mode's call spans: ``batch`` and ``batch.finish`` on every
    sample, equal across the call; the finish holds ``batch.finalize``, and
    the call holds the stream and the finish."""
    ms = run_multi_bam(ref, bams, [str(tmp_path / f"b{i}") for i in range(2)], cap_frags=256, device="cpu")
    for m in ms:
        assert m.spans["batch"] == ms[0].spans["batch"] > 0, m.sample
        assert m.spans["batch.finish"] == ms[0].spans["batch.finish"] > 0, m.sample
        assert m.spans["batch.finish"] >= m.spans["batch.finalize"]
        assert m.spans["batch"] >= m.spans["stream"] + m.spans["batch.finish"]


def test_profiled_run_multi_bam_has_batch_ranges(ref, bams, tmp_path):
    """Under a profiler, batch mode's call is one irf.batch range on the
    calling thread, holding open, stream and one irf.batch.finish, which
    holds batch.finalize and every table's write."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_multi_bam(ref, bams, [str(tmp_path / f"b{i}") for i in range(2)], cap_frags=256, device="cpu")
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    ranges = _ranges(path)
    (batch,) = [r for r in ranges if r[0] == "batch"]
    (finish,) = [r for r in ranges if r[0] == "batch.finish"]
    main = [r for r in ranges if r[3] == batch[3]]
    assert batch[1] <= finish[1] and finish[2] <= batch[2] and finish[3] == batch[3]
    for name in ("open", "stream", "batch.finalize"):
        (r,) = [r for r in main if r[0] == name]
        assert batch[1] <= r[1] and r[2] <= batch[2], name
    (stream,) = [r for r in main if r[0] == "stream"]
    assert stream[2] <= finish[1]
    writes = [r for r in main if r[0].startswith("write.")]
    assert len(writes) == 2 * len(WRITES)
    assert all(finish[1] <= r[1] and r[2] <= finish[2] for r in writes)


@pytest.mark.parametrize("entry", ["run_bam", "run_bam_config", "run_multi_bam", "run_multi_bam_alone"])
def test_batch_counters(ref, bams, tmp_path, monkeypatch, entry):
    """batch_samples, stats_batched and decoder_threads under both entry
    points: run_bam's 4 threads or its RunConfig's; run_multi_bam's budget
    over its samples, with one statistics launch or, past
    MULTI_STATS_BUDGET, one a sample."""
    from irfinder_tpu_torch import engine as E
    from irfinder_tpu_torch.config import RunConfig

    out = str(tmp_path / "out")
    if entry == "run_bam":
        ms, want = [run_bam(ref, bams[0], out, cap_frags=256, device="cpu")], (1, False, 4)
    elif entry == "run_bam_config":
        cfg = RunConfig(cap_frags=256, decoder_threads=3)
        ms, want = [run_bam(ref, bams[0], out, config=cfg, device="cpu")], (1, False, 3)
    else:
        if entry == "run_multi_bam_alone":
            monkeypatch.setattr(E, "MULTI_STATS_BUDGET", 0)
        ms = run_multi_bam(ref, bams, [out + "0", out + "1"], cap_frags=256, device="cpu")
        want = (2, entry == "run_multi_bam", max(1, 2 * (os.cpu_count() or 4) // 2))
    for m in ms:
        assert (m.batch_samples, m.stats_batched, m.decoder_threads) == want
        assert "batch" not in m.spans if entry.startswith("run_bam") else "batch" in m.spans


def test_mesh_spans(ref, bams, tmp_path):
    """The routed mesh records the same phases, and its routing."""
    m = run_bam_mesh(ref, bams[0], str(tmp_path / "mesh"), MeshSpec.parse("dp=2,genome=2,routed"),
                     cap_frags=256, device="cpu")
    for name in TOP + ("route", "stage", "count", "junctions.merge", "decode"):
        assert m.spans.get(name, 0.0) > 0, name
    assert m.route_rows_real > 0


def test_cli_profile_records_the_feeder_threads(ref, bams, tmp_path):
    """BAM --profile writes a chrome trace holding the calling thread's
    ranges, and the feeder threads' decode ranges where the installed torch
    profiles every thread."""
    ref_dir = str(tmp_path / "REF")
    ref.save(ref_dir)
    prof = str(tmp_path / "prof")
    assert cli.main(["BAM", "-r", ref_dir, "-d", str(tmp_path / "out"), "--cap-frags", "256",
                     "--device", "cpu", "--profile", prof, bams[0]]) == 0
    ranges = _ranges(os.path.join(prof, "trace.json"))
    names = {r[0] for r in ranges}
    assert {"open", "stream", "finalize", "write.IR-nondir"} <= names
    if cli.all_threads():
        main_tid = next(r[3] for r in ranges if r[0] == "open")
        assert any(r[0] == "decode" and r[3] != main_tid for r in ranges)


def test_spans_of_one_thread_each_lose_nothing():
    """Threads that each own a span name of one RunMetrics (as the feeders
    and the consumer do) lose no seconds, under a short switch interval."""
    m = RunMetrics()
    n_threads, n_spans = 2 * (os.cpu_count() or 4), 300
    mine = [0.0] * n_threads

    def work(i):
        for _ in range(n_spans):
            with S.span(m, f"t{i}") as sp:
                pass
            mine[i] += sp.s

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert m.spans == {f"t{i}": mine[i] for i in range(n_threads)}


def test_split_span_shares_the_seconds():
    """A split span gives each of its targets an even share; the list is
    read when the span closes."""
    ms = []
    with S.span(ms, "open", split=True) as sp:
        ms.extend([RunMetrics(), RunMetrics()])
    assert [m.spans["open"] for m in ms] == [sp.s / 2] * 2
    with S.span(ms, "finalize") as sp:
        pass
    assert [m.finalize_s for m in ms] == [sp.s] * 2


def test_readers_on_a_real_run(ref, bams, tmp_path):
    """The four span readers, through the benchmark's loader, give finite,
    non-negative numbers on a CPU run_bam, and nothing on metrics without
    spans (an engine that records none)."""
    m = run_bam(ref, bams[0], str(tmp_path / "out"), cap_frags=256, device="cpu")
    run = types.SimpleNamespace(completed=[(0, m), (0, m)])
    bare = types.SimpleNamespace(completed=[(0, types.SimpleNamespace(decode_s=1.0, finalize_s=1.0))])
    for name in READERS:
        v = reader(name)(run)
        assert v is not None and math.isfinite(v) and v >= 0, (name, v)
        assert reader(name)(bare) is None, name
    assert reader("write.s_per_sample")(run) == pytest.approx(sum(m.spans[w] for w in WRITES))
    assert reader("stream.wait_share")(run) <= 100.0


def test_batch_readers_on_a_real_run(ref, bams, tmp_path):
    """The three batch-mode readers read each run_multi_bam call once and
    give finite, positive numbers; on run_bam's samples they give None."""
    ms = run_multi_bam(ref, bams, [str(tmp_path / f"b{i}") for i in range(2)], cap_frags=256, device="cpu")
    call = types.SimpleNamespace(metrics=ms, inputs=[0, 1])
    inputs = [types.SimpleNamespace(records=1000), types.SimpleNamespace(records=3000)]
    run = types.SimpleNamespace(calls=[call, call], inputs=inputs)
    got = {n: reader(n)(run) for n in BATCH_READERS}
    assert all(v is not None and math.isfinite(v) and v > 0 for v in got.values()), got
    s = ms[0].spans
    assert got["batch.finish_share"] == pytest.approx(100.0 * s["batch.finish"] / s["batch"])
    assert got["batch.finish.s_per_sample"] == pytest.approx(s["batch.finish"] / 2)
    assert got["batch.stream.s_per_Mrec"] == pytest.approx(s["stream"] / 4000 * 1e6)
    m = run_bam(ref, bams[0], str(tmp_path / "out"), cap_frags=256, device="cpu")
    solo = types.SimpleNamespace(calls=[types.SimpleNamespace(metrics=[m], inputs=[0])], inputs=inputs)
    for n in BATCH_READERS:
        assert reader(n)(solo) is None, n

