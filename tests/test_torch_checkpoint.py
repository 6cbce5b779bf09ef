"""Checkpoint/resume of the port (irfinder_tpu_torch/checkpoint.py and
engine.run_bam(checkpoint=)) against its own uninterrupted runs and the JAX
package.

A run is interrupted as tests/test_checkpoint.py does it: count the first k
batches, snapshot, abandon the engine.  The resumed run's tables must be
byte-identical to the uninterrupted run's and to the JAX package's; the
snapshot must be gone afterwards.  Snapshots move between the packages in
both directions (their unpacked counters compared, not the .npz bytes: the
JAX device pack escapes -128 and the host packs do not).
"""

import dataclasses
import itertools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from irfinder_tpu import checkpoint as jck
from irfinder_tpu.engine import Engine as JEngine
from irfinder_tpu.engine import open_decoder as j_open_decoder
from irfinder_tpu.engine import run_bam as jax_run_bam
from irfinder_tpu.io.bamgen import write_realistic_bam
from irfinder_tpu.refio.compile import compile_reference
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch import checkpoint as ck
from irfinder_tpu_torch import engine as E
from irfinder_tpu_torch.convert import compiled_ref_from_numpy
from irfinder_tpu_torch.junctions import JuncTally

from test_oracle import CHROMS, ROIS, random_bam_bytes, toy_exons

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = (
    "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt", "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt", "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    "WARNINGS",
)
CAP = 256


def port_ref(ref):
    return compiled_ref_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """ref name -> (JAX ref, port ref, BAM path, cap_frags)."""
    d = tmp_path_factory.mktemp("ckpt")
    synth = synth_ref(n_genes=40)
    write_realistic_bam(str(d / "synth.bam"), synth, n_pairs=2500, seed=1)
    toy = compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS)
    (d / "toy.bam").write_bytes(random_bam_bytes(seed=5, n_frags=400))
    return {
        "synth": (synth, port_ref(synth), str(d / "synth.bam"), CAP),
        "toy": (toy, port_ref(toy), str(d / "toy.bam"), 64),
    }


@pytest.fixture(scope="module")
def jax_solo(inputs, tmp_path_factory):
    """ref name -> the JAX package's uninterrupted output directory."""
    out = {}
    for name, (jref, _, bam, cap) in inputs.items():
        out[name] = str(tmp_path_factory.mktemp(f"jax_{name}"))
        jax_run_bam(jref, bam, out[name], cap_frags=cap)
    return out


def read(d, name):
    with open(os.path.join(d, name), "rb") as fh:
        return fh.read()


def assert_same_tables(a, b):
    for t in TABLES:
        assert read(a, t) == read(b, t), t


def interrupted(pref, bam, cap, k, use_native=True):
    """The port's state after counting the first k batches of ``bam``."""
    eng = E.Engine(pref, device="cpu")
    header, batches, _ = E.open_decoder(pref, bam, cap, use_native)
    eng.reset(n_refids=len(header.ref_names))
    eng.run_stream(itertools.islice(batches, k))
    assert eng.metrics.batches == k
    return eng._st


def jax_interrupted(jref, bam, cap, k):
    eng = JEngine(jref, cap_frags=cap)
    header, batches, _ = j_open_decoder(jref, bam, cap)
    eng.reset(n_refids=len(header.ref_names))
    for b in itertools.islice(batches, k):
        eng.process_batch(b)
    return eng._st


@pytest.mark.parametrize("name, decoder", [("synth", "native"), ("synth", "python"), ("toy", "native")])
def test_resume_matches_uninterrupted_and_jax(name, decoder, inputs, jax_solo, tmp_path):
    _, pref, bam, cap = inputs[name]
    native = decoder == "native"
    solo = str(tmp_path / "solo")
    m_solo = E.run_bam(pref, bam, solo, cap_frags=cap, use_native=native, device="cpu")
    path = str(tmp_path / "state.npz")
    ck.save_checkpoint(path, interrupted(pref, bam, cap, 3, native))
    assert ck.load_checkpoint(path)[2] == 3
    resumed = str(tmp_path / "resumed")
    m = E.run_bam(pref, bam, resumed, cap_frags=cap, use_native=native, checkpoint=path, device="cpu")
    assert not os.path.exists(path), "the snapshot is removed after a successful run"
    assert (m.batches, m.reads_total, m.fragments) == (m_solo.batches, m_solo.reads_total, m_solo.fragments)
    assert_same_tables(resumed, solo)
    assert_same_tables(resumed, jax_solo[name])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_moves_between_packages(direction, inputs, jax_solo, tmp_path):
    """Both packages' snapshots after the same 3 batches hold the same
    state; a snapshot written by either resumes in the other."""
    jref, pref, bam, cap = inputs["synth"]
    p_path, j_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ck.save_checkpoint(p_path, interrupted(pref, bam, cap, 3))
    jck.save_checkpoint(j_path, jax_interrupted(jref, bam, cap, 3))
    mine, theirs = ck.load_checkpoint(p_path), jck.load_checkpoint(j_path)
    for a, b in zip(mine[0], theirs[0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(mine[1].merged(), theirs[1].merged()):
        np.testing.assert_array_equal(a, b)
    assert mine[2:] == theirs[2:] and mine[4] is not None
    assert np.count_nonzero(mine[0][0]) > 0

    out = str(tmp_path / "resumed")
    if direction == "jax_to_port":
        E.run_bam(pref, bam, out, cap_frags=cap, checkpoint=j_path, device="cpu")
        assert not os.path.exists(j_path)
    else:
        jax_run_bam(jref, bam, out, cap_frags=cap, checkpoint=p_path)
        assert not os.path.exists(p_path)
    assert_same_tables(out, jax_solo["synth"])


@pytest.mark.parametrize("change", ["counters", "reference"])
def test_restore_rejects_shape_mismatch(change, inputs, tmp_path):
    _, pref, bam, cap = inputs["synth"]
    st = interrupted(pref, bam, cap, 1)
    engine = E.Engine(pref, device="cpu")
    if change == "counters":
        st.counters = {"cnt": torch.zeros(8, dtype=torch.int32), "chr": st.counters["chr"]}
    else:
        engine = E.Engine(inputs["toy"][1], device="cpu")
    path = str(tmp_path / "bad.npz")
    ck.save_checkpoint(path, st)
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore_state(engine, ck.load_checkpoint(path))


#: values at the pack's edges: the int8 range's ends, one past each, int32's
EDGES = np.array([-128, 127, 128, -129, np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1],
                 np.int32)


@pytest.mark.parametrize("pack", ["card", "host", "raw"])
def test_pack_round_trips(pack, tmp_path, monkeypatch):
    """Each pack stores the counters exactly, the edges included; the card
    and host packs give the JAX package's host-pack fields."""
    rng = np.random.default_rng(0)
    cnt = rng.integers(-5, 6, 1 << 16).astype(np.int32)
    cnt[rng.integers(0, cnt.size, 300)] = rng.integers(-100_000, 100_000, 300)
    cnt[1000 : 1000 + EDGES.size] = EDGES
    cnt[-EDGES.size :] = EDGES
    t = torch.from_numpy(cnt.copy())
    if pack != "raw":
        pull = ck.pull_card if pack == "card" else ck.pull_host
        words, idx, vals, info = pull(t)
        want = jck._pack_host(cnt)
        for g, w in zip((words, idx, vals), want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert set(info) == {"pack_s", "d2h_s"}
        assert set(cnt[idx].tolist()) >= {128, -129, int(EDGES[4]), int(EDGES[5])}
        assert -128 not in cnt[idx] and 127 not in cnt[idx]
        np.testing.assert_array_equal(ck.unpack_words(words, cnt.shape, idx, vals), cnt)
    else:
        monkeypatch.setenv("IRTPU_CKPT_PACK", "0")
        pull = ck.pull_card
    st = E.SampleState(counters={"cnt": t, "chr": torch.tensor([5, 0, 300], dtype=torch.int32)},
                       junc_tally=JuncTally(), resume_token=b"tok")
    st.metrics.batches = 7
    path = str(tmp_path / "snap.npz")
    info = ck.save_checkpoint(path, st, pull=pull)
    assert info["bytes"] == os.path.getsize(path) and not os.path.exists(path + ".tmp.npz")
    with np.load(path) as z:
        assert ("cnt" in z) == (pack == "raw") and ("cnt_words" in z) == (pack != "raw")
    (c, chrn), tally, done, n_refids, token = ck.load_checkpoint(path)
    np.testing.assert_array_equal(c, cnt)
    assert chrn.tolist() == [5, 0, 300] and (done, n_refids, token) == (7, 2, b"tok") and len(tally) == 0


@pytest.mark.parametrize("decoder", ["native", "python"])
def test_snapshot_without_token_resumes_by_skipping(decoder, inputs, tmp_path):
    """A snapshot without a decoder token resumes by decoding again and
    dropping the batches it already counted."""
    _, pref, bam, cap = inputs["synth"]
    native = decoder == "native"
    solo = str(tmp_path / "solo")
    m_solo = E.run_bam(pref, bam, solo, cap_frags=cap, use_native=native, device="cpu")
    st = interrupted(pref, bam, cap, 4, native)
    st.resume_token = None
    path = str(tmp_path / "legacy.npz")
    ck.save_checkpoint(path, st)
    assert ck.load_checkpoint(path)[4] is None
    out = str(tmp_path / "resumed")
    m = E.run_bam(pref, bam, out, cap_frags=cap, use_native=native, checkpoint=path, device="cpu")
    assert m.batches == m_solo.batches and not os.path.exists(path)
    assert_same_tables(out, solo)


def test_no_snapshot_after_a_batch_without_token(inputs, tmp_path, monkeypatch):
    """The Python decoder's end-of-stream batch carries no token.  With a
    snapshot due after every batch, the cadence skips that one: the last
    snapshot holds every batch but the tail and the tail's predecessor's
    token, and resuming from it gives the uninterrupted tables.  With a
    snapshot due only after the tail, none is written."""
    _, pref, bam, cap = inputs["synth"]
    solo = str(tmp_path / "solo")
    n = E.run_bam(pref, bam, solo, cap_frags=cap, use_native=False, device="cpu").batches
    monkeypatch.setattr(E, "SNAPSHOT_COST_FACTOR", 0.0)

    class Killed(Exception):
        pass

    def killed(*a, **k):
        raise Killed("killed before the tables")

    path = str(tmp_path / "state.npz")
    monkeypatch.setattr(E, "write_outputs", killed)
    with pytest.raises(Killed):
        E.run_bam(pref, bam, str(tmp_path / "a"), cap_frags=cap, use_native=False,
                  checkpoint=path, checkpoint_every=n, device="cpu")
    assert not os.path.exists(path)
    with pytest.raises(Killed):
        E.run_bam(pref, bam, str(tmp_path / "b"), cap_frags=cap, use_native=False,
                  checkpoint=path, checkpoint_every=1, device="cpu")
    snap = ck.load_checkpoint(path)
    assert snap[2] == n - 1 and snap[4] is not None
    monkeypatch.undo()
    out = str(tmp_path / "resumed")
    m = E.run_bam(pref, bam, out, cap_frags=cap, use_native=False, checkpoint=path, device="cpu")
    assert m.batches == n
    assert_same_tables(out, solo)


@pytest.mark.parametrize("every", [1, 3])
def test_cadence_snapshots_and_cleans_up(every, inputs, tmp_path, monkeypatch):
    """Without the wall floor, the cadence snapshots every ``every``
    batches (RunMetrics.checkpoints counts them), the tables are the
    uninterrupted ones and the snapshot is gone."""
    _, pref, bam, cap = inputs["synth"]
    solo = str(tmp_path / "solo")
    n = E.run_bam(pref, bam, solo, cap_frags=cap, device="cpu").batches
    monkeypatch.setattr(E, "SNAPSHOT_COST_FACTOR", 0.0)
    path = str(tmp_path / "state.npz")
    out = str(tmp_path / "out")
    m = E.run_bam(pref, bam, out, cap_frags=cap, checkpoint=path, checkpoint_every=every, device="cpu")
    assert m.checkpoints == n // every and m.checkpoint_s > 0 and not os.path.exists(path)
    assert_same_tables(out, solo)


def test_cli_checkpoint_resumes_and_removes_the_snapshot(inputs, jax_solo, tmp_path):
    """python -m irfinder_tpu_torch.cli BAM --checkpoint S --device cpu
    resumes from S, exits 0 and removes S."""
    jref, pref, bam, cap = inputs["synth"]
    ref_dir = str(tmp_path / "ref")
    jref.save(ref_dir)
    path = str(tmp_path / "S.npz")
    ck.save_checkpoint(path, interrupted(pref, bam, cap, 2))
    out = str(tmp_path / "cli")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "irfinder_tpu_torch.cli", "BAM", "-r", ref_dir, "-d", out,
         "--checkpoint", path, "--checkpoint-every", "4", "--cap-frags", str(cap), "--device", "cpu", bam],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert not os.path.exists(path)
    assert_same_tables(out, jax_solo["synth"])
