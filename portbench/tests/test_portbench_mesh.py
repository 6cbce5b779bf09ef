"""The cell grch38.mesh_dp4: BASELINE config E's data-parallel deployment,
run_bam_mesh at dp=4 with one mesh cell on each of the cell's four cards.
Its spec keeps grch38's map and depth; a small CPU run (the four cells on
the CPU) is correct, fills the span readers and makes four count launches
a batch; each fault of the mesh's timed path makes a run not correct;
load_spec refuses a mesh that does not fit its cell; and the trace's
reduction keeps the cards apart, reducing on one card exactly as it did
before it kept them apart."""

import collections
import json
import os
import random
import time

import pytest

from portbench import harness as H
from portbench import trace as T
from portbench.tests.conftest import small_map

CELL = "grch38.mesh_dp4"
#: the run_bam family's per-layer metrics that read the program's spans
SPAN_READERS = ("decode.s_per_Mrec", "decode.pool_wait_share", "stream.wait_share",
                "open.s_per_sample", "finalize.s_per_sample", "junctions.s_per_sample",
                "write.s_per_sample", "stage.s_per_Mrec")
#: the cell's per-layer metrics read from the device trace
TRACE_READERS = ("count_step_roofline", "intron_stats_roofline", "device.idle_share",
                 "mesh.merge.s_per_sample")


def _config(name):
    with open(os.path.join(H.ROOT, "portbench", "configs", name + ".json")) as fh:
        return json.load(fh)


def _run(small, monkeypatch, seed=2**33 + 4099):
    """A small CPU run of the cell on a three-chromosome map, at 40,000
    pairs a sample: more than one batch's 32,768 fragments, so that every
    dp cell counts reads (a batch is cut into four equal lane ranges, and a
    sample's last batch holds its rows in its first lanes).  Returns
    (result, the Run its readers were handed)."""
    small["config"].update(map=small_map(genes=90, chromosomes=3), pairs_per_sample=40_000)
    seen = {}
    orig = H.reader

    def spy(name):
        read = orig(name)

        def keep(run):
            seen["run"] = run
            return read(run)

        return keep

    monkeypatch.setattr(H, "reader", spy)
    r = H.run_cell(CELL, seed, 0.3, False, time.perf_counter(), device="cpu",
                   overrides=small, log=lambda s: None)
    return r, seen["run"]


def test_spec():
    """Four chips, as many as the mesh's cells; grch38's map, depth, cut,
    guarantees and assumptions, with only the mesh, the name, the source
    and the deployment its own."""
    from irfinder_tpu_torch.engine_mesh import MeshSpec

    spec = H.load_spec(CELL)
    mesh = MeshSpec.parse(spec.config["mesh"])
    assert (mesh.dp, mesh.genome, mesh.routed) == (4, 1, False)
    assert spec.cell["chips"] == mesh.n_devices == 4
    assert spec.traffic == {"samples_per_call": 1}
    base, own = _config("grch38"), dict(spec.config)
    for k in ("mesh", "name", "source", "deployment"):
        own.pop(k)
        base.pop(k, None)
    assert own == base
    with open(os.path.join(H.ROOT, "BENCHMARK.json")) as fh:
        entry = {c["name"]: c for c in json.load(fh)["configs"]}[spec.cell["config"]]
    assert spec.config["source"] == entry["source"] and entry["reduced"] == ["pairs_per_sample"]
    assert {m["name"] for m in spec.end_to_end} == {"reads_per_s", "device_peak_GB", "setup_s"}
    assert {m["name"] for m in spec.per_layer} == set(SPAN_READERS) | set(TRACE_READERS)


def test_small_run_is_correct(small, monkeypatch):
    """Every sample correct; each call runs run_bam_mesh at dp=4 over four
    cells (all on the CPU here) and launches count_step four times a batch;
    the span readers are filled and the trace readers read nothing without
    a trace."""
    from irfinder_tpu_torch import engine_mesh as EM

    launches, seen = [0], []
    orig_step, orig_run = EM.count_step, EM.run_bam_mesh

    def step(dref, counters, batch):
        launches[0] += 1
        orig_step(dref, counters, batch)

    def run(pref, bam, out, spec, devices=None):
        before = launches[0]
        m = orig_run(pref, bam, out, spec, devices=devices)
        seen.append((spec, [str(d) for d in devices], launches[0] - before, m.batches))
        return m

    monkeypatch.setattr(EM, "count_step", step)
    monkeypatch.setattr(EM, "run_bam_mesh", run)
    r, got = _run(small, monkeypatch)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert got.inputs[0].records > 2 * 32_768
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}
    assert r["device"]["count"] == 4 and r["device"]["memory_peak_bytes"] == 0
    assert len(seen) == r["attempted"] + 1  # the warm-up, then the window's calls
    for spec, devices, n, batches in seen:
        assert str(spec) == "dp=4,genome=1" and devices == ["cpu"] * 4
        assert batches >= 1 and n == 4 * batches
    vals = {n: H.reader(n)(got) for n in SPAN_READERS}
    assert all(v is not None and v >= 0 for v in vals.values()), vals
    assert all(vals[n] > 0 for n in SPAN_READERS if n != "decode.pool_wait_share"), vals
    records = sum(got.inputs[i].records for i, _ in got.completed)
    assert vals["stage.s_per_Mrec"] == pytest.approx(
        sum(m.spans["stage"] for _, m in got.completed) / records * 1e6)
    for n in TRACE_READERS:
        assert H.reader(n)(got) is None, n


def _state_unchanged(EM, E, monkeypatch):
    monkeypatch.setattr(EM, "count_step", lambda dref, counters, batch: None)


def _half_batch(EM, E, monkeypatch):
    """Every other block and fragment of each cell's rows left out."""
    orig = EM.count_step

    def half(dref, counters, batch):
        b = {k: v.clone() for k, v in batch.items()}
        b["blk_chrom"][1::2] = -1
        b["frag_refid"][1::2] = -1
        b["frag_chrom"][1::2] = -1
        orig(dref, counters, b)

    monkeypatch.setattr(EM, "count_step", half)


def _merge_left_out(EM, E, monkeypatch):
    """The exchange between cards left out: the dp-0 cell's counters taken
    for the sum over dp."""
    monkeypatch.setattr(EM, "merge_dp", lambda cells: list(cells[0]))


def _one_cell_doubled(EM, E, monkeypatch):
    """The counters of the third dp cell counted twice before the merge."""
    orig = EM.MeshEngine.merged_shards

    def doubled(self, st):
        for k in ("cnt", "chr"):
            st.counters[k][2][0].mul_(2)
        return orig(self, st)

    monkeypatch.setattr(EM.MeshEngine, "merged_shards", doubled)


def _answer_altered(EM, E, monkeypatch):
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
          "merge_left_out": _merge_left_out, "one_cell_doubled": _one_cell_doubled,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, small, monkeypatch):
    from irfinder_tpu_torch import engine as E
    from irfinder_tpu_torch import engine_mesh as EM

    FAULTS[fault](EM, E, monkeypatch)
    r, _ = _run(small, monkeypatch)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("over,match", [
    ({"config": {"mesh": "dp=2"}}, "asks for 4 chips"),
    ({"config": {"mesh": "dp=2,genome=4"}}, "asks for 4 chips"),
    ({"traffic": {"samples_per_call": 2}}, "one sample a call"),
    ({"traffic": {"long_reads": True}}, "long_reads"),
])
def test_load_spec_refuses(over, match):
    """A mesh whose cells are not the cell's chips, a mesh traffic of
    several samples a call, and a long-read mesh traffic are refused."""
    with pytest.raises(SystemExit, match=match):
        H.load_spec(CELL, over)


def test_mesh_of_the_cells_chips_loads():
    """dp=2,genome=2 has four cells: it loads."""
    assert H.load_spec(CELL, {"config": {"mesh": "dp=2,genome=2"}}).config["mesh"] == "dp=2,genome=2"


# -- the trace of several cards ------------------------------------------------

def _trace(path, spans, kernels):
    """A chrome trace as torch.profiler exports it: ``spans`` (start, end,
    name) as the benchmark's ranges, ``kernels`` (start, end, name, device,
    category) as device events, microseconds.  A copy between cards names
    its card ``inDevice``, as the profiler writes it, and other events
    ``device``."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": T.SPAN_PREFIX + n, "ts": s,
           "dur": e - s} for s, e, n in spans]
    ev += [{"ph": "X", "cat": cat, "name": n, "ts": s, "dur": e - s, "pid": d,
            "args": ({"fromDevice": 1 - d, "inDevice": d, "toDevice": d} if "PtoP" in n
                     else {"device": d, "stream": 7})} for s, e, n, d, cat in kernels]
    ev.append({"ph": "i", "cat": "cpu_op", "name": "marker", "ts": 0})
    with open(path, "w") as fh:
        json.dump({"traceEvents": ev}, fh)
    return path


def test_two_cards(tmp_path):
    """Each card's union apart; busy_s their mean; device_time summed over
    the cards; idle gaps only where neither card worked."""
    spans = [(0, 10_000, "window"), (0, 6_000, "call 0 run_bam_mesh dp=2"),
             (6_000, 10_000, "call 1 run_bam_mesh dp=2")]
    kernels = [
        (1_000, 2_000, "count_step", 0, "kernel"), (1_500, 2_500, "count_step", 0, "kernel"),
        (1_800, 3_000, "count_step", 1, "kernel"),
        (5_000, 5_500, "Memcpy PtoP (Device -> Device)", 0, "gpu_memcpy"),
        (8_000, 9_000, "Memcpy HtoD (Pinned -> Device)", 1, "gpu_memcpy"),
        (9_500, 12_000, "Memset (Device)", 1, "gpu_memset"),
    ]
    tr = T.reduce(_trace(str(tmp_path / "t.json"), spans, kernels), cards=2)
    assert tr.window_s == pytest.approx(0.010)
    assert tr.card_busy_s == pytest.approx({0: 0.002, 1: 0.0027})
    assert tr.busy_s == pytest.approx((0.002 + 0.0027) / 2)
    assert tr.device_time == pytest.approx({"count_step": 0.0032, "Memcpy PtoP (Device -> Device)": 0.0005,
                                            "Memcpy HtoD (Pinned -> Device)": 0.001,
                                            "Memset (Device)": 0.0005})
    # no card works in [0, 1000], [3000, 5000], [5500, 8000], [9000, 9500]
    got = sorted(round(s, 6) for _, s in tr.idle_gaps)
    assert got == [0.0005, 0.001, 0.002, 0.0025]
    where = dict((round(s, 6), n) for n, s in tr.idle_gaps)
    assert where[0.001] == "call 0 run_bam_mesh dp=2 at +0.000 s of 0.006 s"
    assert where[0.002] == "call 0 run_bam_mesh dp=2 at +0.003 s of 0.006 s"
    # a card of the run with no work in the window counts as idle
    assert T.reduce(str(tmp_path / "t.json"), cards=4).busy_s == pytest.approx((0.002 + 0.0027) / 4)


def _reduce_one_card(path, top=10):
    """The reduction as it stood before it kept cards apart: every device
    interval in one union."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, dev = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in T.DEVICE_CATS:
            dev.append((ts, ts + dur, name))
        elif cat == "user_annotation" and name.startswith(T.SPAN_PREFIX):
            spans.append((ts, ts + dur, name[len(T.SPAN_PREFIX):]))
    w0, w1 = [s for s in spans if s[2] == "window"][0][:2]
    calls = sorted(s for s in spans if s[2] != "window")
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    busy = T._union([(s, e) for s, e, _ in inside])
    by_name = collections.defaultdict(float)
    for s, e, n in inside:
        by_name[n] += (e - s) / 1e6
    gaps, last = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)

    def where(t0, t1):
        mid = (t0 + t1) / 2
        for s, e, n in calls:
            if s <= mid <= e:
                return f"{n} at +{(t0 - s) / 1e6:.3f} s of {(e - s) / 1e6:.3f} s"
        return "harness, between calls"

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return T.Trace(window_s=(w1 - w0) / 1e6, busy_s=sum(e - s for s, e in busy) / 1e6,
                   device_time=dict(by_name),
                   idle_gaps=[(where(s, e), (e - s) / 1e6) for s, e in gaps[:top]])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_one_card_reads_as_before(tmp_path, seed):
    """On one card every field of the Trace is what the single-union
    reduction gave, bit for bit: ~2,000 overlapping kernels, copies and
    sets on two streams over 30 calls, some reaching past the window."""
    rng = random.Random(seed)
    t, spans = 1_000.0, []
    for k in range(30):
        d = rng.uniform(20_000, 60_000)
        spans.append((t, t + d, f"call {k} run_bam"))
        t += d + rng.uniform(0, 500)
    spans.append((1_000.0, spans[-1][1], "window"))
    names = [("count_step_kernel", "kernel"), ("intron_stats_kernel", "kernel"),
             ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy"), ("Memset (Device)", "gpu_memset")]
    kernels = []
    for _ in range(2_000):
        s = rng.uniform(0, t + 5_000)
        n, cat = rng.choice(names)
        kernels.append((s, s + rng.expovariate(1 / 150), n, 0, cat))
    path = _trace(str(tmp_path / "t.json"), spans, kernels)
    old, new = _reduce_one_card(path), T.reduce(path)
    assert (new.window_s, new.busy_s, new.device_time, new.idle_gaps) == \
        (old.window_s, old.busy_s, old.device_time, old.idle_gaps)
    assert new.card_busy_s == {0: old.busy_s}
    assert T.breakdown(new) == T.breakdown(old)
