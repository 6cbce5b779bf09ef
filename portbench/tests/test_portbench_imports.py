"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), and the reference and the read writers import nothing of the
program."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.harness import FORBIDDEN, HERE, ROOT


def _modules():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not set(_imports(path)) & set(FORBIDDEN), path


def test_top_level_names_compared_whole():
    """irfinder_tpu_torch is the program, not the JAX package."""
    assert "irfinder_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "irfinder_tpu.engine".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("sub", ["reference", "frozen", "reads"])
def test_reference_imports_nothing_of_the_program(sub):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                assert "irfinder_tpu_torch" not in set(_imports(path)), path


def test_reference_loads_nothing_of_the_program():
    """Importing and running the reference loads no module of the program,
    nor JAX (a fresh interpreter)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import reference as R, control\n"
        "import json, os, tempfile\n"
        "from portbench import genome, records\n"
        "m = json.load(open(os.path.join(%r, 'portbench/configs/chr21.json')))['map']\n"
        "m['genes'] = 20\n"
        "ref = genome.make_map(m)\n"
        "bam = os.path.join(tempfile.mkdtemp(), 'x.bam')\n"
        "records.write_bam(bam, ref, 300, 1)\n"
        "R.sample_tables(ref, bam)\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'irfinder_tpu_torch', 'irfinder_tpu', 'jax', 'jaxlib', 'flax', 'torch'})\n"
        "print(bad)\n" % (ROOT, ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
