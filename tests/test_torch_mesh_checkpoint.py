"""Checkpoint/resume of the port's mesh (run_bam_mesh(checkpoint=),
MeshEngine.restore_state, checkpoint.save_checkpoint on a mesh state)
against its own uninterrupted runs and the JAX package's mesh.

A mesh snapshot stacks the cells' counters (dp, genome, ...) as the JAX mesh
stores them, so snapshots cross between the packages in both directions;
their unpacked counters are compared, not the .npz bytes (the JAX device
pack escapes -128 and the host packs do not).
"""

import itertools
import os

import numpy as np
import pytest
import torch

from irfinder_tpu import checkpoint as jck
from irfinder_tpu.engine import open_decoder as j_open_decoder
from irfinder_tpu.engine import run_bam as jax_run_bam
from irfinder_tpu.engine_mesh import MeshEngine as JMeshEngine
from irfinder_tpu.engine_mesh import MeshSpec as JMeshSpec
from irfinder_tpu.io.bamgen import write_realistic_bam
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch import checkpoint as ck
from irfinder_tpu_torch import engine as E
from irfinder_tpu_torch.engine_mesh import MeshEngine, MeshSpec, run_bam_mesh

from test_torch_mesh import TABLES, absent_contig_bam, port_ref

CAP = 256
ROUTED = MeshSpec(dp=2, genome=4, routed=True)
REPLICATED = MeshSpec(dp=2, genome=4)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(JAX ref, port ref, BAM path, the JAX unsharded output directory)."""
    d = tmp_path_factory.mktemp("meshck")
    jref = synth_ref(n_genes=30, n_chroms=4, chrom_len=2_000_000)
    bam = str(d / "in.bam")
    write_realistic_bam(bam, jref, n_pairs=3000, seed=5)
    jax_run_bam(jref, bam, str(d / "jax"), cap_frags=CAP)
    return jref, port_ref(jref), bam, str(d / "jax")


def read(d, name):
    with open(os.path.join(d, name), "rb") as fh:
        return fh.read()


def assert_same_tables(a, b):
    for t in TABLES:
        assert read(a, t) == read(b, t), t


def port_interrupted(pref, bam, spec, k, cap=CAP):
    """The port's mesh state after the first k batches of ``bam``."""
    eng = MeshEngine(pref, spec, ["cpu"] * spec.n_devices, cap_frags=cap)
    header, batches, _ = E.open_decoder(pref, bam, cap)
    st = eng.new_state(len(header.ref_names))
    eng.run_stream(itertools.islice(batches, k), st)
    assert st.metrics.batches == k and st.resume_token is not None
    return eng, st


def test_interrupted_run_resumes_byte_identical(inputs, tmp_path, monkeypatch):
    """A dp=2,genome=4,routed run stopped right after its first snapshot
    (the cadence's, on the consumer thread) resumes from it to the
    uninterrupted tables; the snapshot is removed afterwards."""
    _, pref, bam, jdir = inputs
    solo = str(tmp_path / "solo")
    m_solo = run_bam_mesh(pref, bam, solo, ROUTED, cap_frags=CAP, device="cpu")
    assert m_solo.batches > 4
    assert_same_tables(solo, jdir)

    class Stop(Exception):
        pass

    real_save = ck.save_checkpoint
    saved = []

    def save_and_stop(path, st, **kw):
        saved.append(st.metrics.batches)
        real_save(path, st, **kw)
        raise Stop()

    monkeypatch.setattr(E, "SNAPSHOT_COST_FACTOR", 0.0)
    monkeypatch.setattr(ck, "save_checkpoint", save_and_stop)
    path = str(tmp_path / "mesh.npz")
    with pytest.raises(Stop):
        run_bam_mesh(pref, bam, str(tmp_path / "part"), ROUTED, cap_frags=CAP, checkpoint=path,
                     checkpoint_every=2, device="cpu")
    monkeypatch.undo()
    assert saved == [2]
    snap = ck.load_checkpoint(path)
    assert snap[2] == 2 and snap[4] is not None
    assert snap[0][0].shape[:2] == (2, 4) and snap[0][1].shape[:2] == (2, 4)
    out = str(tmp_path / "resumed")
    m = run_bam_mesh(pref, bam, out, ROUTED, cap_frags=CAP, checkpoint=path, device="cpu")
    assert not os.path.exists(path)
    assert (m.batches, m.reads_total, m.fragments) == (m_solo.batches, m_solo.reads_total, m_solo.fragments)
    assert_same_tables(out, solo)


def test_snapshot_without_token_raises(inputs, tmp_path):
    _, pref, bam, _ = inputs
    _, st = port_interrupted(pref, bam, ROUTED, 2)
    st.resume_token = None
    path = str(tmp_path / "legacy.npz")
    ck.save_checkpoint(path, st)
    with pytest.raises(ValueError, match="token"):
        run_bam_mesh(pref, bam, str(tmp_path / "o"), ROUTED, cap_frags=CAP, checkpoint=path, device="cpu")
    assert os.path.exists(path)


def test_snapshot_holds_the_header_refid_count(tmp_path):
    """n_refids in a mesh snapshot is the BAM header's (3 here: the map's 2
    contigs and one absent from it), not the leading dp axis; a snapshot
    under another --mesh shape is refused."""
    from irfinder_tpu.refio.compile import compile_reference
    from test_oracle import CHROMS, ROIS, toy_exons

    pref = port_ref(compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS))
    bam = str(tmp_path / "a.bam")
    with open(bam, "wb") as fh:
        fh.write(absent_contig_bam())
    eng, st = port_interrupted(pref, bam, MeshSpec(dp=2, genome=2, routed=True), 2, cap=64)
    path = str(tmp_path / "s.npz")
    ck.save_checkpoint(path, st)
    with np.load(path) as z:
        assert int(z["n_refids"]) == 3 and z["chrn"].shape == (2, 2, 4)
    snap = ck.load_checkpoint(path)
    assert snap[3] == 3
    rs = eng.restore_state(snap)
    for k in ("cnt", "chr"):
        for i, g in itertools.product(range(2), range(2)):
            assert torch.equal(rs.counters[k][i][g], st.counters[k][i][g]), (k, i, g)
    with pytest.raises(ValueError, match="shape mismatch"):
        MeshEngine(pref, MeshSpec(dp=4, genome=1), ["cpu"] * 4).restore_state(snap)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mesh_snapshot_moves_between_packages(direction, inputs, tmp_path):
    """Both packages' dp=2,genome=4 snapshots after the same 3 batches hold
    the same stacked counters, tally and token.  The JAX package's resumes in
    the port to the unsharded tables; the port's restores in the JAX mesh."""
    jref, pref, bam, jdir = inputs
    k = 3
    jeng = JMeshEngine(jref, JMeshSpec(dp=2, genome=4), cap_frags=CAP)
    header, batches, _ = j_open_decoder(jref, bam, CAP)
    jst = jeng.new_state(n_refids=len(header.ref_names))
    for b in itertools.islice(batches, k):
        jeng.process_batch(b, jst)
    j_path, p_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jck.save_checkpoint(j_path, jst)
    _, pst = port_interrupted(pref, bam, REPLICATED, k)
    ck.save_checkpoint(p_path, pst)

    mine, theirs = jck.load_checkpoint(p_path), ck.load_checkpoint(j_path)
    for a, b, want in zip(mine[0], theirs[0], (jst.counters["cnt"], jst.counters["chr"])):
        want = np.asarray(want)
        assert a.dtype == b.dtype == want.dtype and a.shape == want.shape
        assert np.array_equal(a, want) and np.array_equal(b, want)
    for a, b in zip(mine[1].merged(), theirs[1].merged()):
        np.testing.assert_array_equal(a, b)
    assert mine[2:] == theirs[2:] and mine[4] is not None

    out = str(tmp_path / "resumed")
    if direction == "jax_to_port":
        run_bam_mesh(pref, bam, out, REPLICATED, cap_frags=CAP, checkpoint=j_path, device="cpu")
        assert not os.path.exists(j_path)
        assert_same_tables(out, jdir)
    else:
        rs = JMeshEngine(jref, JMeshSpec(dp=2, genome=4), cap_frags=CAP).restore_state(mine)
        for key in ("cnt", "chr"):
            np.testing.assert_array_equal(np.asarray(rs.counters[key]), np.asarray(jst.counters[key]))


#: values at the pack's edges: the int8 range's ends, one past each, int32's
EDGES = np.array([-128, 127, 128, -129, np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0, -1], np.int32)


@pytest.mark.parametrize("pack", ["card", "host"])
def test_cell_by_cell_pack_equals_the_whole(pack):
    """pull_cells over a (2, 3) mesh of cells gives pack_host's fields of
    the stacked array: the words concatenate and each cell's escape indices
    are offset by the cells before it."""
    rng = np.random.default_rng(1)
    L = 4 * 1000
    stacked = rng.integers(-5, 6, (2, 3, L)).astype(np.int32)
    for i, g in itertools.product(range(2), range(3)):
        stacked[i, g, rng.integers(0, L, 20)] = rng.integers(-100_000, 100_000, 20)
        stacked[i, g, 7 * (i + g) : 7 * (i + g) + EDGES.size] = EDGES
    cells = [torch.from_numpy(stacked[i, g].copy()) for i in range(2) for g in range(3)]
    words, idx, vals, info = ck.pull_cells(cells, ck.pull_card if pack == "card" else ck.pull_host)
    for got, want in zip((words, idx, vals), ck.pack_host(stacked)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert idx.max() >= 5 * L and set(info) == {"pack_s", "d2h_s"}
    np.testing.assert_array_equal(ck.unpack_words(words, stacked.shape, idx, vals), stacked)
