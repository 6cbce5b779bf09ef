"""Tests of the benchmark (``python -m pytest portbench/tests``).  Tests
that need an NVIDIA card carry the ``cuda`` marker and ask for the
``cuda_card`` fixture, which skips them without one; on the card run them
with ``python -m pytest portbench/tests -m cuda``."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")


def small_map(genes: int = 60, chromosomes: int = 1) -> dict:
    """The chr21 configuration's map parameters at ``genes`` genes, over
    ``chromosomes`` chromosomes of chr21's length."""
    import json

    with open(os.path.join(ROOT, "portbench", "configs", "chr21.json")) as fh:
        m = json.load(fh)["map"]
    length = next(iter(m["chromosomes"].values()))
    m["chromosomes"] = {f"chr{20 + k}": length for k in range(1, chromosomes + 1)}
    m["genes"] = genes
    return m


@pytest.fixture
def small(monkeypatch):
    """Overrides that cut a cell to a size a CPU test can hold: a few dozen
    genes, 3,000 pairs or 1,500 long reads a sample, 500 pairs or 300 long
    reads a warm-up."""
    from portbench import inputs
    from portbench.reads import longread

    monkeypatch.setattr(inputs, "WARMUP_PAIRS", 500)
    monkeypatch.setattr(longread, "WARMUP", {"reads_per_sample": 300})
    return {"config": {"map": small_map(), "pairs_per_sample": 3000},
            "traffic": {"reads_per_sample": 1500}}
