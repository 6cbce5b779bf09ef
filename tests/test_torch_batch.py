"""The port's batch mode (run_multi_bam, CLI ``Batch``) against the JAX
package's and against its own single-sample runs.

Each sample's six tables and WARNINGS must be byte-identical, metrics.json
equal on its count fields, and the pooled differential of ``Batch --a --b``
byte-identical to the JAX CLI's.  The port gets the reference converted from
the JAX package's (convert.compiled_ref_from_numpy).

The batched finalize (Engine.results_multi_async: one statistics launch and
one small-counter pull for every sample) is held to the JAX package's
batched finalize, which IRTPU_DEVICE_STATS=1 engages on the CPU (its
lax.map over the Pallas kernels, in interpret mode); past
MULTI_STATS_BUDGET the samples finalize one at a time, to the same tables.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from irfinder_tpu import cli as jax_cli
from irfinder_tpu.engine import Engine as JEngine
from irfinder_tpu.engine import open_decoder as j_open_decoder
from irfinder_tpu.engine import run_multi_bam as jax_run_multi_bam
from irfinder_tpu.io.bamgen import write_realistic_bam
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch import cli
from irfinder_tpu_torch import engine as E
from irfinder_tpu_torch import format as fmt
from irfinder_tpu_torch.convert import compiled_ref_from_numpy
from irfinder_tpu_torch.engine import Engine, open_decoder, run_bam, run_multi_bam

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
def pref(ref):
    """The port's CompiledRef of ``ref``, carried as data."""
    return compiled_ref_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})


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


def test_multi_bam_matches_jax(ref, pref, bams, tmp_path):
    ours = [str(tmp_path / "torch" / f"s{i}") for i in range(len(bams))]
    theirs = [str(tmp_path / "jax" / f"s{i}") for i in range(len(bams))]
    ms = run_multi_bam(pref, bams, ours, cap_frags=512, device="cpu")
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


def test_multi_bam_matches_solo_runs(pref, bams, tmp_path):
    outs = [str(tmp_path / "multi" / f"s{i}") for i in range(len(bams))]
    ms = run_multi_bam(pref, bams, outs, cap_frags=256, device="cpu")
    for i, bam in enumerate(bams):
        solo = str(tmp_path / "solo" / f"s{i}")
        m = run_bam(pref, bam, solo, cap_frags=256, device="cpu")
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


def test_multi_stream_stress_many_feeders(pref, bams):
    """More feeders than cores, with a short switch interval: every sample
    fed the same BAM ends with the counters of a solo stream (a lost or
    misrouted batch would break the equality)."""
    import sys
    import threading

    import torch

    from irfinder_tpu_torch.engine import Engine, open_decoder

    n = 2 * (os.cpu_count() or 4)
    eng = Engine(pref, device="cpu")
    header, batches, _ = open_decoder(pref, bams[0], 128, n_threads=1)
    eng.reset(n_refids=len(header.ref_names))
    eng.run_stream(batches)
    sts, streams = [], []
    for _ in range(n):
        header, batches, _ = open_decoder(pref, bams[0], 128, n_threads=1)
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
def test_multi_stream_surfaces_faults(fault, pref):
    """A decoder error, or a batch whose columns were never filled, in one
    sample's feeder raises on the caller's thread; every feeder exits."""
    import threading

    from irfinder_tpu_torch.engine import Engine
    from irfinder_tpu_torch.io.batch import PackedBatch

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

    eng = Engine(pref, device="cpu")
    streams = [(good(), eng.new_state(1)), (bad(), eng.new_state(1))]
    before = threading.active_count()
    with pytest.raises(ValueError if fault == "decoder_error" else RuntimeError):
        eng.run_multi_stream(streams)
    assert threading.active_count() == before


def _stream(eng, pref, bams, cap=512) -> list:
    """Every BAM counted into its own state of the port's ``eng``."""
    sts, streams = [], []
    for p in bams:
        header, batches, _ = open_decoder(pref, p, cap)
        sts.append(eng.new_state(n_refids=len(header.ref_names)))
        streams.append((batches, sts[-1]))
    eng.run_multi_stream(streams)
    return sts


def _ir_text(rows) -> str:
    import io

    buf = io.StringIO()
    fmt.write_ir_table(buf, rows)
    return buf.getvalue()


def _same_bundle(got: dict, want: dict) -> None:
    assert set(got["counters"]) == set(want["counters"])
    for k, w in want["counters"].items():
        g = got["counters"][k]
        if w is None:
            assert g is None, k
            continue
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    for key in ("rows_nondir", "rows_dir"):
        assert _ir_text(got[key]) == _ir_text(want[key]), key
    assert bool(got["stranded"]) == bool(want["stranded"])
    assert bool(got["flip_strand"]) == bool(want["flip_strand"])


def test_results_multi_async_matches_jax(ref, pref, bams, monkeypatch):
    """Engine.results_multi_async's bundles equal the JAX package's batched
    finalize sample by sample; the port's statistics of all samples come
    from one call, its small counters from one pull."""
    monkeypatch.setenv("IRTPU_DEVICE_STATS", "1")
    jeng = JEngine(ref, cap_frags=512)
    jsts, jstreams = [], []
    for p in bams:
        h, it, _ = j_open_decoder(ref, p, 512)
        jsts.append(jeng.new_state(n_refids=len(h.ref_names)))
        jstreams.append((it, jsts[-1], h.chrom_lut))
    jeng.run_multi_stream(jstreams)
    want = [f() for f in jeng.results_multi_async(jsts)]

    calls = {"stats": [], "pulls": 0}
    real_stats, real_pull = E.device_all_stats_multi_async, E.pull_concat_async

    def stats_spy(ref_, finref, depths, plane_as, *a, **kw):
        calls["stats"].append(list(plane_as))
        return real_stats(ref_, finref, depths, plane_as, *a, **kw)

    def pull_spy(arrays):
        calls["pulls"] += 1
        return real_pull(arrays)

    monkeypatch.setattr(E, "device_all_stats_multi_async", stats_spy)
    monkeypatch.setattr(E, "pull_concat_async", pull_spy)
    eng = Engine(pref, cap_frags=512, device="cpu")
    sts = _stream(eng, pref, bams)
    got = [f() for f in eng.results_multi_async(sts)]
    assert calls["stats"] == [[1 if w["flip_strand"] else 0 for w in want]]
    assert calls["pulls"] == 1
    for g, w in zip(got, want):
        _same_bundle(g, w)
    assert any(w["stranded"] for w in want), "one sample must take the dir polarity path"
    for st, jst in zip(sts, jsts):
        assert st.metrics.finalize_s > 0
        for k in ("is_stranded", "flip_strand", "dir_concordance", "dir_informative"):
            assert getattr(st.metrics, k) == getattr(jst.metrics, k), k


def test_multi_bam_matches_jax_batched_device_stats(ref, pref, bams, tmp_path, monkeypatch):
    """run_multi_bam through the batched finalize: every sample's tables and
    WARNINGS byte-identical to the JAX package's batched finalize."""
    monkeypatch.setenv("IRTPU_DEVICE_STATS", "1")
    ours = [str(tmp_path / "torch" / f"s{i}") for i in range(len(bams))]
    theirs = [str(tmp_path / "jax" / f"s{i}") for i in range(len(bams))]
    run_multi_bam(pref, bams, ours, cap_frags=512, device="cpu")
    jax_run_multi_bam(ref, bams, theirs, cap_frags=512)
    for o, t in zip(ours, theirs):
        for name in TABLES:
            assert _read(o, name) == _read(t, name), (o, name)


def test_batched_pull_keeps_each_counter(pref, bams):
    """The batched finalize's small counters, from one concatenated pull,
    have results_async's keys, dtypes, shapes (n_frags 0-d) and values."""
    eng = Engine(pref, cap_frags=512, device="cpu")
    sts = _stream(eng, pref, bams)
    solo = [eng.results_async(st)() for st in sts]
    for g, w in zip([f() for f in eng.results_multi_async(sts)], solo):
        _same_bundle(g, w)
        assert g["counters"]["n_frags"].shape == ()


def test_pull_concat_keeps_dtypes_and_shapes():
    """pull_concat_async returns every tensor with its own dtype and shape,
    0-d and empty ones included, from one byte buffer."""
    rng = np.random.default_rng(7)
    arrays = [
        {"a": torch.from_numpy(rng.integers(-9, 9, (2, 5)).astype(np.int32)),
         "b": torch.tensor(3, dtype=torch.int32), "c": torch.zeros((2, 0), dtype=torch.int32)},
        {"a": torch.from_numpy(rng.integers(-2**40, 2**40, 3)), "d": torch.tensor([1, 255], dtype=torch.uint8),
         "e": torch.arange(10, dtype=torch.int16).view(2, 5)[:, ::2]},
    ]
    got = E.pull_concat_async(arrays)()
    assert [set(g) for g in got] == [set(a) for a in arrays]
    for g, a in zip(got, arrays):
        for k, t in a.items():
            w = t.numpy()
            assert g[k].dtype == w.dtype and g[k].shape == w.shape, k
            np.testing.assert_array_equal(g[k], w)


def test_over_budget_finalizes_one_sample_at_a_time(pref, bams, tmp_path, monkeypatch):
    """Past MULTI_STATS_BUDGET each sample finalizes whole (finalize_device,
    statistics, bundle) before the next one's finalize_device starts, and
    the tables equal the batched run's.  Within it every finalize_device
    runs before the first bundle."""
    events = []
    real_fin, real_bundle = E.finalize_device, E.result_bundle

    def fin_spy(dref, counters):
        events.append(("finalize_device", id(counters)))
        return real_fin(dref, counters)

    def bundle_spy(ref_, joined, fc, cache):
        events.append(("bundle", None))
        return real_bundle(ref_, joined, fc, cache)

    monkeypatch.setattr(E, "finalize_device", fin_spy)
    monkeypatch.setattr(E, "result_bundle", bundle_spy)
    n = len(bams)
    batched = [str(tmp_path / "batched" / f"s{i}") for i in range(n)]
    run_multi_bam(pref, bams, batched, cap_frags=512, device="cpu")
    assert [e[0] for e in events] == ["finalize_device"] * n + ["bundle"] * n
    events.clear()
    monkeypatch.setattr(E, "MULTI_STATS_BUDGET", 0)
    serial = [str(tmp_path / "serial" / f"s{i}") for i in range(n)]
    run_multi_bam(pref, bams, serial, cap_frags=512, device="cpu")
    assert [e[0] for e in events] == ["finalize_device", "bundle"] * n
    assert len({e[1] for e in events[::2]}) == n
    for b, s_ in zip(batched, serial):
        for name in TABLES:
            assert _read(b, name) == _read(s_, name), (s_, name)


@pytest.mark.parametrize("entry", ["run_bam", "results_fc", "mesh"])
def test_every_finalize_is_one_composition(entry, pref, bams, tmp_path, monkeypatch):
    """run_bam, Engine.results(fc) and the mesh finalize through
    finalize_async: one statistics call over one depth a finalize.
    run_bam's small counters come back in one pull_concat_async; results(fc)
    holds them on the host already and the mesh reassembles them there, so
    neither starts one.  The tables equal run_bam's."""
    from irfinder_tpu_torch.engine_mesh import MeshSpec, run_bam_mesh

    calls = {"stats": [], "pulls": 0}
    real_stats, real_pull = E.device_all_stats_multi_async, E.pull_concat_async

    def stats_spy(ref_, finref, depths, plane_as, *a, **kw):
        calls["stats"].append(len(depths))
        return real_stats(ref_, finref, depths, plane_as, *a, **kw)

    def pull_spy(arrays):
        calls["pulls"] += 1
        return real_pull(arrays)

    solo = str(tmp_path / "solo")
    run_bam(pref, bams[1], solo, cap_frags=512, device="cpu")
    monkeypatch.setattr(E, "device_all_stats_multi_async", stats_spy)
    monkeypatch.setattr(E, "pull_concat_async", pull_spy)
    out = str(tmp_path / entry)
    if entry == "run_bam":
        m = run_bam(pref, bams[1], out, cap_frags=512, device="cpu")
    elif entry == "mesh":
        m = run_bam_mesh(pref, bams[1], out, MeshSpec.parse("dp=2,genome=2,routed"),
                         cap_frags=512, device="cpu")
    else:
        eng = Engine(pref, cap_frags=512, device="cpu")
        header, batches, _ = open_decoder(pref, bams[1], 512)
        eng.reset(n_refids=len(header.ref_names))
        eng.run_stream(batches)
        res = eng.results(eng.counters_host())
        with open(os.path.join(solo, "IRFinder-IR-dir.txt")) as fh:
            assert _ir_text(res["rows_dir"]) == fh.read()
        m = eng.metrics
    assert calls == {"stats": [1], "pulls": int(entry == "run_bam")}
    assert m.finalize_s > 0 and m.is_stranded
    if entry != "results_fc":
        for name in TABLES:
            assert _read(out, name) == _read(solo, name), (entry, name)
