"""The port's multi-process path (irfinder_tpu_torch/parallel/multihost.py
run_bam_multihost): two CPU processes under gloo, each a mesh over its own
cells, count the round-robin halves of one BAM's batches; after the merge
(an integer all_reduce of each genome shard's counters, the junction
tallies gathered) process 0 writes all seven outputs, byte-identical to the
JAX package's unsharded run_bam and to the port's.

The processes meet through a file in tmp_path (init_method file://), so no
port is picked and none can be taken by another test.
"""

import dataclasses
import os
import subprocess
import sys

import pytest

from irfinder_tpu.engine import run_bam as jax_run_bam
from irfinder_tpu.io.bamgen import write_realistic_bam
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch.convert import compiled_ref_from_numpy
from irfinder_tpu_torch.engine import run_bam

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAP = 256
REF = dict(n_genes=30, n_chroms=4, chrom_len=2_000_000)
TABLES = (
    "IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt", "IRFinder-JuncCount.txt",
    "IRFinder-SpansPoint.txt", "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt",
    "WARNINGS",
)

WORKER = r"""
import sys
rendezvous, rank, out, bam, cap, mesh = sys.argv[1:]
import torch.distributed as dist
from irfinder_tpu_torch.conformance import synth_ref
from irfinder_tpu_torch.engine_mesh import MeshSpec
from irfinder_tpu_torch.parallel import multihost as MH

MH.initialize(rendezvous, 2, int(rank), device="cpu")
spec = MeshSpec.parse(mesh)
m = MH.run_bam_multihost(synth_ref(**%r), bam, out, spec, cap_frags=int(cap), device="cpu")
with open(out + ".batches" + rank, "w") as fh:
    fh.write(str(m.batches))
dist.destroy_process_group()
""" % (REF,)


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """(BAM path, the JAX run_bam's output directory, the port's, batches)."""
    d = tmp_path_factory.mktemp("mh")
    jref = synth_ref(**REF)
    bam = str(d / "in.bam")
    write_realistic_bam(bam, jref, n_pairs=3000, seed=9)
    jax_run_bam(jref, bam, str(d / "jax"), cap_frags=CAP)
    pref = compiled_ref_from_numpy({f.name: getattr(jref, f.name) for f in dataclasses.fields(jref)})
    m = run_bam(pref, bam, str(d / "port"), cap_frags=CAP, device="cpu")
    return bam, str(d / "jax"), str(d / "port"), m.batches


def read(d, name):
    with open(os.path.join(d, name), "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("mesh", ["genome=2,routed", "dp=2,genome=2"])
def test_two_processes_equal_one(mesh, single, tmp_path):
    bam, jdir, tdir, n_batches = single
    assert n_batches > 3
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    out = str(tmp_path / "out")
    rendezvous = "file://" + str(tmp_path / "rendezvous")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), rendezvous, str(r), out, bam, str(CAP), mesh],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for r in range(2)
    ]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    shares = []
    for r in range(2):
        with open(out + ".batches" + str(r)) as fh:
            shares.append(int(fh.read()))
    assert sorted(shares) == [n_batches // 2, n_batches - n_batches // 2]
    for t in TABLES:
        assert read(out, t) == read(jdir, t), t
        assert read(out, t) == read(tdir, t), t
