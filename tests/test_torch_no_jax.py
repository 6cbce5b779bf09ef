"""The port must run where JAX is not installed (the machine with the card).

A fresh interpreter imports every irfinder_tpu_torch module and chip_smoke,
runs the CPU path of run_bam on a tiny BAM and of run_multi_bam on two, and
checks that no ``jax`` module was ever imported.
"""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib, os, pkgutil, sys, tempfile
import irfinder_tpu_torch
for m in pkgutil.walk_packages(irfinder_tpu_torch.__path__, "irfinder_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from irfinder_tpu.io.bamgen import write_realistic_bam
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch.engine import run_bam, run_multi_bam
ref = synth_ref(n_genes=8, chrom_len=1_000_000)
with tempfile.TemporaryDirectory() as d:
    bam = os.path.join(d, "t.bam")
    write_realistic_bam(bam, ref, n_pairs=400, seed=0)
    m = run_bam(ref, bam, os.path.join(d, "out"), cap_frags=128, device="cpu")
    assert m.batches > 1 and m.fragments > 0, m
    assert os.path.getsize(os.path.join(d, "out", "IRFinder-IR-nondir.txt")) > 0
    bam2 = os.path.join(d, "u.bam")
    write_realistic_bam(bam2, ref, n_pairs=300, seed=1)
    outs = [os.path.join(d, "b0"), os.path.join(d, "b1")]
    ms = run_multi_bam(ref, [bam, bam2], outs, cap_frags=128, device="cpu")
    assert all(x.fragments > 0 for x in ms), ms
    assert all(os.path.getsize(os.path.join(o, "IRFinder-IR-dir.txt")) > 0 for o in outs)
jax_mods = sorted(k for k in sys.modules if k == "jax" or k.startswith("jax."))
assert not jax_mods, jax_mods
print("NO_JAX_OK")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_never_imports_jax():
    r = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout


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
    """chip_smoke.py reaches the shared host pieces through the port
    (irfinder_tpu_torch.conformance), never the JAX package or JAX itself."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    assert "irfinder_tpu_torch" in {m.split(".")[0] for m in mods}
    bad = sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "irfinder_tpu"))
    assert not bad, bad
