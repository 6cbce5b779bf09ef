"""The port's dp x genome mesh (irfinder_tpu_torch/engine_mesh.py,
parallel/genome.py, parallel/shard.py) against the JAX package's mesh and
against the unsharded runs of both packages.

* The host functions (plan_shards, slice_ref, route_flat_batch) give the JAX
  functions' fields on a BAM whose contigs are all in the reference.
* The padded shard DeviceRefs: count_step_plain on each shard, from the JAX
  stacked DeviceRef (convert.shard_device_refs_from_numpy), equals the JAX
  count_step on that shard, integer-exact on cnt and chr.
* run_bam_mesh on the CPU at dp8, dp2xg4, dp2xg4-routed and dp4xg2-routed
  writes all seven outputs byte-identical to the port's and the JAX
  package's unsharded run_bam, on the toy map of tests/test_oracle.py and on
  a synthetic one; the routed modes also on a BAM with a contig absent from
  the map (where the JAX routed mesh drops that contig's fragments).
* The device rules, MeshSpec.parse and ``BAM --mesh`` through cli.main.

All counters are integers: every comparison is exact.
"""

import dataclasses
import io
import os

import jax
import numpy as np
import pytest
import torch

from irfinder_tpu.engine import run_bam as jax_run_bam
from irfinder_tpu.engine_mesh import MeshSpec as JMeshSpec
from irfinder_tpu.io import bamwrite
from irfinder_tpu.io.bamgen import write_realistic_bam
from irfinder_tpu.io.bampy import decode_bam as j_decode_bam
from irfinder_tpu.ops import step as jstep
from irfinder_tpu.parallel import genome as jgenome
from irfinder_tpu.parallel.shard import pad_batch_to_multiple as j_pad
from irfinder_tpu.refio.compile import compile_reference
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch import cli
from irfinder_tpu_torch.convert import compiled_ref_from_numpy, shard_device_refs_from_numpy
from irfinder_tpu_torch.engine import open_decoder, run_bam
from irfinder_tpu_torch.engine_mesh import MeshEngine, MeshSpec, mesh_devices, run_bam_mesh
from irfinder_tpu_torch.ops import step as tstep
from irfinder_tpu_torch.ops.device_ref import COLUMNS
from irfinder_tpu_torch.parallel import genome as tgenome
from irfinder_tpu_torch.parallel import shard as tshard

from test_oracle import CHROMS, ROIS, random_bam_bytes, toy_exons

TABLES = (
    "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt", "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt", "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    "WARNINGS",
)
SPECS = {
    "dp8": MeshSpec(dp=8),
    "dp2xg4": MeshSpec(dp=2, genome=4),
    "dp2xg4-routed": MeshSpec(dp=2, genome=4, routed=True),
    "dp4xg2-routed": MeshSpec(dp=4, genome=2, routed=True),
}


def port_ref(ref):
    return compiled_ref_from_numpy({f.name: getattr(ref, f.name) for f in dataclasses.fields(ref)})


def absent_contig_bam(seed: int = 3, n_pairs: int = 200) -> bytes:
    """A BAM against the toy map whose header has a third contig, chrUn,
    absent from the map; about a third of the pairs lie on it."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n_pairs):
        rid = int(rng.integers(0, 3))
        pos = int(rng.integers(0, 2200))
        cig = ["100M", "40M300N60M", "50M10S"][int(rng.integers(0, 3))]
        records += bamwrite.make_pair(f"p{i}", rid, pos, cig, pos + int(rng.integers(50, 300)), "60M",
                                      reverse1=bool(rng.integers(0, 2)))
    buf = io.BytesIO()
    bamwrite.write_bam(buf, CHROMS + ["chrUn"], [5000, 5000, 5000], records)
    return buf.getvalue()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """ref name -> (JAX ref, port ref, BAM path, the JAX unsharded output
    directory, the port's unsharded output directory)."""
    d = tmp_path_factory.mktemp("mesh")
    toy = compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS)
    (d / "toy.bam").write_bytes(random_bam_bytes(seed=31, n_frags=400))
    (d / "absent.bam").write_bytes(absent_contig_bam())
    synth = synth_ref(n_genes=30, n_chroms=4, chrom_len=2_000_000)
    write_realistic_bam(str(d / "synth.bam"), synth, n_pairs=3000, seed=11)
    out = {}
    for name, jref, bam, cap in (("toy", toy, "toy.bam", 64), ("absent", toy, "absent.bam", 64),
                                 ("synth", synth, "synth.bam", 512)):
        jdir, tdir = str(d / f"jax_{name}"), str(d / f"port_{name}")
        pref = port_ref(jref)
        jax_run_bam(jref, str(d / bam), jdir, cap_frags=cap)
        run_bam(pref, str(d / bam), tdir, cap_frags=cap, device="cpu")
        out[name] = (jref, pref, str(d / bam), jdir, tdir, cap)
    return out


def read(d, name):
    with open(os.path.join(d, name), "rb") as fh:
        return fh.read()


def assert_same_tables(a, b):
    for t in TABLES:
        assert read(a, t) == read(b, t), t


@pytest.mark.parametrize("name", ["toy", "synth"])
@pytest.mark.parametrize("n_g", [2, 4])
def test_host_functions_match_jax(name, n_g, inputs):
    """plan_shards, slice_ref and route_flat_batch: the JAX package's fields."""
    jref, pref, bam, _, _, cap = inputs[name]
    jp, tp = jgenome.plan_shards(jref, n_g), tgenome.plan_shards(pref, n_g)
    assert (jp.bounds, jp.pads, jp.real) == (tp.bounds, tp.pads, tp.real)
    for i in range(n_g):
        js = jgenome.slice_ref(jref, jp.bounds[i], jp.bounds[i + 1])
        ts = tgenome.slice_ref(pref, tp.bounds[i], tp.bounds[i + 1])
        for f in dataclasses.fields(js):
            a, b = getattr(js, f.name), getattr(ts, f.name)
            if isinstance(a, list):
                assert a == b, f.name
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    with open(bam, "rb") as fh:
        _, batches, _ = j_decode_bam(fh, {c: i for i, c in enumerate(jref.chroms)}, cap_frags=cap)
        batches = list(batches)
    assert len(batches) > 1
    caps = (0, 0)
    for b in batches:
        for n_dp in (1, 2):
            arrays = j_pad(b.device_arrays(), n_dp)
            assert all(np.array_equal(a, t) for a, t in zip(
                arrays.values(), tshard.pad_batch_to_multiple(b.device_arrays(), n_dp).values()))
            jr, jc = jgenome.route_flat_batch(jp, arrays, n_dp, n_g, min_caps=caps)
            tr, tc = tgenome.route_flat_batch(tp, arrays, n_dp, n_g, min_caps=caps)
            assert np.array_equal(jc, tc)
            assert jr.keys() == tr.keys()
            for k in jr:
                assert jr[k].dtype == tr[k].dtype and np.array_equal(jr[k], tr[k]), k
        caps = (256, 128)


@pytest.mark.parametrize("n_g", [2, 4])
def test_padded_shards_count_as_jax(n_g, inputs):
    """Each genome shard's padded DeviceRef, converted from the JAX stacked
    DeviceRef, counts with count_step_plain what the JAX count_step counts on
    that shard; the port's own shard columns equal the converted ones."""
    jref, pref, bam, _, _, cap = inputs["synth"]
    plan = jgenome.plan_shards(jref, n_g)
    sdref = jgenome.build_stacked_dref(jref, plan)
    cols = {k: getattr(sdref, k) if k == "mbs_size_static" else np.asarray(getattr(sdref, k)) for k in COLUMNS}
    drefs = shard_device_refs_from_numpy(cols)
    own = tgenome.shard_columns(pref, tgenome.plan_shards(pref, n_g))
    for i, c in enumerate(own):
        for k in COLUMNS:
            want = cols[k] if k == "mbs_size_static" else cols[k][i]
            assert np.array_equal(np.asarray(c[k]), want), (i, k)
    with open(bam, "rb") as fh:
        _, batches, _ = j_decode_bam(fh, {c: i for i, c in enumerate(jref.chroms)}, cap_frags=cap)
        batches = [b.device_arrays() for b in batches]
    n_refids = len(jref.chroms)
    step = jax.jit(jstep.count_step)
    for i, dref in enumerate(drefs):
        jd = jax.tree_util.tree_map(lambda v: v[i], sdref)
        jc = jstep.init_counters(jd, n_refids)
        tc = tstep.init_counters(dref, n_refids)
        lay = tstep.CounterLayout.build(dref)
        assert lay.mbs == plan.pads["mbs"] and int(dref.uspan_off[-1]) == plan.real[i]["mbs"]
        for b in batches:
            jc = step(jd, jc, {k: jax.numpy.asarray(v) for k, v in b.items()})
            tstep.count_step_plain(dref, tc, {k: torch.from_numpy(v.copy()) for k, v in b.items()},
                                   lay, tstep.OVERHANG)
        for k in ("cnt", "chr"):
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=f"shard {i} {k}")
        assert int(tc["cnt"][lay.off_nf]) > 0


def test_dp_cells_count_as_jax_sharded_step(inputs):
    """MeshEngine at dp=4, genome=1 (the dp step), fed batch by batch
    through process_batch: every cell's counters equal the JAX sharded
    step's slice for that dp shard, and merge_stacked over the cells equals
    the JAX merge_stacked, integer-exact."""
    from jax.sharding import Mesh

    from irfinder_tpu.ops.device_ref import build_device_ref as j_build_device_ref
    from irfinder_tpu.parallel import shard as jshard

    jref, pref, bam, _, _, cap = inputs["synth"]
    n = 4
    step, place_batch, place_counters = jshard.make_sharded_step(Mesh(np.array(jax.devices()[:n]), ("dp",)))
    jdref = j_build_device_ref(jref)
    eng = MeshEngine(pref, MeshSpec(dp=n), ["cpu"] * n, cap_frags=cap)
    header, batches, _ = open_decoder(pref, bam, cap)
    n_refids = len(header.ref_names)
    st = eng.new_state(n_refids)
    jc = place_counters(jshard.stacked_counters(jdref, n_refids, n))
    for b in batches:
        eng.process_batch(b, st)
        jc = step(jdref, jc, place_batch(j_pad(b.device_arrays(), n)))
    assert st.metrics.batches > 1
    cells = [{k: st.counters[k][i][0] for k in ("cnt", "chr")} for i in range(n)]
    for i, c in enumerate(cells):
        assert int(c["cnt"].count_nonzero()) > 0
        for k in c:
            np.testing.assert_array_equal(c[k].numpy(), np.asarray(jc[k][i]), err_msg=f"cell {i} {k}")
    merged, jm = tshard.merge_stacked(cells), jshard.merge_stacked(jc)
    for k in merged:
        np.testing.assert_array_equal(merged[k].numpy(), np.asarray(jm[k]), err_msg=k)


@pytest.mark.parametrize("name", ["toy", "synth"])
@pytest.mark.parametrize("spec", list(SPECS))
def test_run_bam_mesh_tables_byte_identical(spec, name, inputs, tmp_path):
    jref, pref, bam, jdir, tdir, cap = inputs[name]
    out = str(tmp_path / "mesh")
    m = run_bam_mesh(pref, bam, out, SPECS[spec], cap_frags=cap, device="cpu")
    assert m.fragments > 0 and m.batches > 1
    assert m.device.startswith(f"mesh {SPECS[spec]}: {SPECS[spec].n_devices} cells on cpu")
    if SPECS[spec].routed:
        assert m.route_rows_padded >= m.route_rows_real > 0
    assert_same_tables(out, tdir)
    assert_same_tables(out, jdir)


@pytest.mark.parametrize("spec", ["dp2xg4-routed", "dp4xg2-routed"])
def test_routed_counts_contigs_absent_from_the_map(spec, inputs, tmp_path):
    """A pair on a BAM contig the map lacks counts in ChrCoverage and the
    fragment total under routing too: the tables equal the unsharded run's
    (the JAX routed mesh writes 0 for that contig)."""
    _, pref, bam, jdir, tdir, cap = inputs["absent"]
    chrcov = read(tdir, "IRFinder-ChrCoverage.txt").decode()
    assert "chrUn" in chrcov and "chrUn\t0" not in chrcov
    out = str(tmp_path / "mesh")
    run_bam_mesh(pref, bam, out, SPECS[spec], cap_frags=cap, device="cpu")
    assert_same_tables(out, tdir)
    assert_same_tables(out, jdir)


@pytest.mark.parametrize("text", ["dp=2,genome=4,routed", "dp=8", "genome=8", " dp=3 , routed ,", "tp=2",
                                  "dp=0", "genome=x"])
def test_mesh_spec_parse_matches_jax(text):
    try:
        want = JMeshSpec.parse(text)
    except ValueError:
        with pytest.raises(ValueError):
            MeshSpec.parse(text)
        return
    got = MeshSpec.parse(text)
    assert (got.dp, got.genome, got.routed, got.n_devices) == (want.dp, want.genome, want.routed, want.n_devices)


def test_genome_on_one_device_runs_unsharded(inputs, tmp_path):
    """genome=4 with one device: the unsharded Engine, identical tables, and
    metrics.device names that path."""
    _, pref, bam, jdir, tdir, cap = inputs["synth"]
    out = str(tmp_path / "one")
    m = run_bam_mesh(pref, bam, out, MeshSpec(genome=4, routed=True), devices=["cpu"], cap_frags=cap)
    assert m.device.startswith("unsharded Engine on cpu")
    assert read(out, "metrics.json").decode().count("unsharded Engine on cpu") == 1
    assert_same_tables(out, tdir)


@pytest.mark.parametrize("case", ["dp_short", "g_short", "too_many", "engine"])
def test_too_few_devices_raise(case, inputs, tmp_path):
    _, pref, bam, _, _, cap = inputs["toy"]
    spec, devs = {
        "dp_short": (MeshSpec(dp=2, genome=2), ["cpu"] * 3),
        "g_short": (MeshSpec(dp=2, genome=4, routed=True), ["cpu"]),
        "too_many": (MeshSpec(dp=2), ["cpu"] * 3),
        "engine": (MeshSpec(genome=4), ["cpu"]),
    }[case]
    with pytest.raises(ValueError, match="needs"):
        if case == "engine":
            MeshEngine(pref, spec, devs)
        else:
            run_bam_mesh(pref, bam, str(tmp_path / "o"), spec, devices=devs, cap_frags=cap)
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.parametrize("how", ["default", "explicit"])
def test_cuda_without_a_card_raises(how, inputs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    _, pref, bam, _, _, cap = inputs["toy"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if how == "default":
            run_bam_mesh(pref, bam, str(tmp_path / "o"), MeshSpec(dp=2), cap_frags=cap)
        else:
            mesh_devices(MeshSpec(dp=2), devices=["cuda:0", "cuda:0"])
    assert not os.path.exists(tmp_path / "o")


def test_cli_bam_mesh(inputs, tmp_path):
    jref, _, bam, jdir, tdir, cap = inputs["synth"]
    ref_dir = str(tmp_path / "ref")
    jref.save(ref_dir)
    out = str(tmp_path / "cli")
    assert cli.main(["BAM", "-r", ref_dir, "-d", out, "--mesh", "dp=2,genome=2,routed", "--cap-frags",
                     str(cap), "--device", "cpu", bam]) == 0
    assert_same_tables(out, tdir)
    assert_same_tables(out, jdir)
