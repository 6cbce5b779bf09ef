"""The port must run where neither JAX nor the JAX package is installed (the
machine with the card).

* Every ``.py`` file of irfinder_tpu_torch, and chip_smoke.py, imports
  neither ``jax`` nor ``irfinder_tpu`` (an AST scan).
* A fresh interpreter imports every irfinder_tpu_torch module and
  chip_smoke, runs the CPU path of run_bam on a tiny BAM and of
  run_multi_bam on two, with inputs from irfinder_tpu_torch.conformance, one
  checkpoint-interrupt-resume, one routed dp x genome mesh run, one
  FastQ run off a stand-in aligner's pipe, and the workflow from an
  annotation (BuildRef off a GTF, BAM on the built reference, Diff,
  ExportGLM, Goldens), and checks that no ``jax`` and no ``irfinder_tpu``
  module was ever imported.
* A copy of irfinder_tpu_torch alone, in an empty directory, does the same
  with nothing else on its PYTHONPATH: it builds its host C++ components
  from its own sources.
"""

import ast
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "irfinder_tpu_torch")

RUN = r"""
import itertools, os, stat, sys, tempfile
from irfinder_tpu_torch import cli
from irfinder_tpu_torch.checkpoint import save_checkpoint
from irfinder_tpu_torch.conformance import synth_ref, write_realistic_bam
from irfinder_tpu_torch.engine import Engine, open_decoder, run_bam, run_multi_bam
from irfinder_tpu_torch.engine_mesh import MeshSpec, run_bam_mesh
ref = synth_ref(n_genes=8, chrom_len=1_000_000)
with tempfile.TemporaryDirectory() as d:
    bam = os.path.join(d, "t.bam")
    write_realistic_bam(bam, ref, n_pairs=400, seed=0)
    m = run_bam(ref, bam, os.path.join(d, "out"), cap_frags=128, device="cpu")
    assert m.batches > 1 and m.fragments > 0, m
    for t in ("IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt", "IRFinder-JuncCount.txt",
              "IRFinder-SpansPoint.txt", "IRFinder-ROI.txt", "IRFinder-ChrCoverage.txt"):
        assert os.path.getsize(os.path.join(d, "out", t)) > 0, t
    bam2 = os.path.join(d, "u.bam")
    write_realistic_bam(bam2, ref, n_pairs=300, seed=1)
    outs = [os.path.join(d, "b0"), os.path.join(d, "b1")]
    ms = run_multi_bam(ref, [bam, bam2], outs, cap_frags=128, device="cpu")
    assert all(x.fragments > 0 for x in ms), ms
    assert all(os.path.getsize(os.path.join(o, "IRFinder-IR-dir.txt")) > 0 for o in outs)

    def same(a, b):
        for t in ("IRFinder-IR-nondir.txt", "IRFinder-JuncCount.txt", "IRFinder-ChrCoverage.txt"):
            with open(os.path.join(d, a, t)) as fa, open(os.path.join(d, b, t)) as fb:
                assert fa.read() == fb.read(), (a, b, t)

    eng = Engine(ref, device="cpu")
    header, batches, _ = open_decoder(ref, bam, 128)
    eng.reset(n_refids=len(header.ref_names))
    eng.run_stream(itertools.islice(batches, 2))
    ck = os.path.join(d, "ck.npz")
    save_checkpoint(ck, eng._st)
    m2 = run_bam(ref, bam, os.path.join(d, "resumed"), cap_frags=128, checkpoint=ck, device="cpu")
    assert m2.batches == m.batches and not os.path.exists(ck)
    same("out", "resumed")
    run_bam_mesh(ref, bam, os.path.join(d, "mesh"), MeshSpec.parse("dp=2,genome=2,routed"), cap_frags=128,
                 device="cpu")
    same("out", "mesh")
    ref.save(os.path.join(d, "REF"))
    fake = os.path.join(d, "aligner.sh")
    with open(fake, "w") as fh:
        fh.write("#!/bin/sh\ncat " + bam + "\n")
    os.chmod(fake, os.stat(fake).st_mode | stat.S_IEXEC)
    assert cli.main(["FastQ", "-r", os.path.join(d, "REF"), "-d", os.path.join(d, "fq"), bam,
                     "--aligner-cmd", fake + " {r1}", "--stream", "--device", "cpu"]) == 0
    same("out", "fq")
    # the user's workflow from an annotation: BuildRef off a GTF (with
    # synth_ref's ROIs as a BED), BAM on the CPU off the built reference,
    # then the table readers
    from irfinder_tpu_torch.synth import synth_exons
    gtf = os.path.join(d, "ann.gtf")
    with open(gtf, "w") as fh:
        for e in synth_exons(n_genes=8, chrom_len=1_000_000):
            fh.write(f"{e.chrom}\tsynth\texon\t{e.start + 1}\t{e.end}\t.\t{e.strand}\t.\t"
                     f'gene_id "{e.gene_id}"; transcript_id "{e.transcript_id}";\n')
    bed = os.path.join(d, "roi.bed")
    with open(bed, "w") as fh:
        fh.write("chr21\t0\t50000\trRNA-like\t0\t+\nchr21\t50000\t60000\tMt-like\t0\t.\n")
    gref = os.path.join(d, "GREF")
    assert cli.main(["BuildRef", "-g", gtf, "-r", gref, "--roi", bed]) == 0
    with open(os.path.join(gref, "ref.json")) as fa, open(os.path.join(d, "REF", "ref.json")) as fb:
        assert fa.read() == fb.read()
    assert cli.main(["BAM", "-r", gref, "-d", os.path.join(d, "gtf_out"), bam, "--device", "cpu"]) == 0
    same("out", "gtf_out")
    assert cli.main(["Diff", "-a", os.path.join(d, "out"), "-b", os.path.join(d, "b1"),
                     "-d", os.path.join(d, "diff.txt")]) == 0
    assert cli.main(["ExportGLM", "-d", os.path.join(d, "glm"), os.path.join(d, "out"),
                     os.path.join(d, "gtf_out"), "--conditions", "A,B"]) == 0
    assert cli.main(["Goldens", os.path.join(d, "gtf_out"), os.path.join(d, "out")]) == 0
    assert os.path.getsize(os.path.join(d, "diff.txt")) > 0
    assert os.path.getsize(os.path.join(d, "glm", "GLM-counts.tsv")) > 0
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "irfinder_tpu"))
assert not bad, bad
print("NO_JAX_OK")
"""

SCRIPT = r"""
import importlib, pkgutil
import irfinder_tpu_torch
for m in pkgutil.walk_packages(irfinder_tpu_torch.__path__, "irfinder_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
""" + RUN


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _imports(path: str) -> set:
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def _port_sources() -> list:
    out = []
    for d, dirs, files in os.walk(PORT):
        dirs[:] = [x for x in dirs if x not in ("_build", "__pycache__")]
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_never_imports_jax():
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """No statement in any .py file of the port imports jax or
    irfinder_tpu, lazily inside a function or not."""
    files = _port_sources()
    assert len(files) > 20
    rel = {os.path.relpath(f, PORT) for f in files}
    assert {
        "checkpoint.py", "engine_mesh.py", os.path.join("native", "trim_native.py"),
        "glm.py", "goldens.py", "oracle.py", os.path.join("io", "bamwrite.py"),
        os.path.join("refio", "mapgen.py"),
        *(os.path.join("parallel", f) for f in ("__init__.py", "genome.py", "shard.py", "multihost.py")),
    } <= rel
    bad = {}
    for path in files:
        hit = sorted(m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "irfinder_tpu"))
        if hit:
            bad[os.path.relpath(path, ROOT)] = hit
    assert not bad, bad


def test_port_runs_alone(tmp_path):
    """irfinder_tpu_torch copied alone into an empty directory runs the CPU
    path of run_bam and run_multi_bam, and the workflow from a GTF, with
    only that directory on its PYTHONPATH, building its host components from
    its own sources."""
    shutil.copytree(PORT, tmp_path / "irfinder_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(tmp_path)
    r = subprocess.run(
        [sys.executable, "-c", RUN], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=400,
    )
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout
    built = os.listdir(tmp_path / "irfinder_tpu_torch" / "_build")
    assert any(f.startswith("libbamdecode_") for f in built), built


def test_chip_smoke_refuses_without_card():
    """chip_smoke.py has no CPU path: without a CUDA card it exits non-zero
    and prints no result."""
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches the host pieces through the port
    (irfinder_tpu_torch.conformance), never the JAX package or JAX itself."""
    mods = _imports(os.path.join(ROOT, "chip_smoke.py"))
    assert "irfinder_tpu_torch" in {m.split(".")[0] for m in mods}
    bad = sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "irfinder_tpu"))
    assert not bad, bad
