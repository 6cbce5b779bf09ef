"""The benchmark's inputs, made from the cell's files and ``--seed``: the
compiled map of a configuration (genome.py) and the BAMs of a traffic mix.

A configuration file (``configs/<name>.json``) holds ``map``, the map's
parameters (genome.py), and ``pairs_per_sample``.  A traffic file
(``traffic/<name>.json``) holds ``samples_per_call``: the samples in one
call of the entry point (1: ``run_bam``; more: ``run_multi_bam`` over that
many).  A run makes one BAM for each sample of a call, each from its own
seed, and every call of its window reads those BAMs.

The reads are records.py's paired-end mix at the configuration's
``pairs_per_sample``, unless the traffic file names another kind in
``reads``: the module ``reads/<name>.py``, which gives
``write_bam(path, ref, config, traffic, seed) -> records`` (its size and
shape from the traffic file) and ``WARMUP``, the traffic keys that its
warm-up sample replaces.
"""

from __future__ import annotations

import dataclasses
import importlib
import os

import numpy as np

from . import genome, records

#: the seeds of the inputs, drawn from --seed below this
_MAX_SEED = 1 << 62
#: pairs in each warm-up sample: a short prefix of the cell's shape
WARMUP_PAIRS = 40_000


@dataclasses.dataclass
class Input:
    path: str
    records: int


def make_map(config: dict):
    """The configuration's compiled map."""
    return genome.make_map(config["map"])


def make_inputs(work: str, ref, config: dict, traffic: dict, seed: int) -> tuple:
    """(inputs, warm-up inputs), one of each for every sample of a call,
    written under ``work``.  Their seeds come from ``seed``; their sizes do
    not."""
    spc = int(traffic["samples_per_call"])
    seeds = np.random.default_rng(seed).integers(0, _MAX_SEED, 2 * spc).tolist()
    kind = traffic.get("reads")
    mod = read_kind(kind) if kind else None

    def bam(name: str, warm: bool, s: int) -> Input:
        path = os.path.join(work, name + ".bam")
        if mod is None:
            pairs = WARMUP_PAIRS if warm else int(config["pairs_per_sample"])
            return Input(path, records.write_bam(path, ref, pairs, s))
        tr = {**traffic, **mod.WARMUP} if warm else traffic
        return Input(path, mod.write_bam(path, ref, config, tr, s))

    inputs = [bam(f"input{i}", False, seeds[i]) for i in range(spc)]
    warm = [bam(f"warmup{i}", True, seeds[spc + i]) for i in range(spc)]
    return inputs, warm


def read_kind(name: str):
    """The module reads/<name>.py, which writes the BAMs of a traffic whose
    ``reads`` is ``name``."""
    return importlib.import_module(f"{__package__}.reads.{name}")
