"""The frozen generator under portbench/frozen/ draws the same read mix as
the port's own; records.py encodes that draw whole (SEQ, QUAL, tags) with
the same alignments; the configurations' maps have the sizes their files
state."""

import dataclasses
import json
import os

import numpy as np
import pytest

from portbench import genome, records
from portbench.frozen import bamgen
from portbench.harness import ROOT
from portbench.reference.decode import decode, inflate, read_header, record_offsets
from portbench.tests.conftest import small_map


@pytest.fixture(scope="module")
def ref():
    return genome.make_map(small_map())


@pytest.mark.parametrize("seed", [7, 2**31 + 99])
def test_bam_bytes_equal_port(tmp_path, ref, seed):
    from irfinder_tpu_torch.io import bamgen as port

    mine, theirs = tmp_path / "a.bam", tmp_path / "b.bam"
    sa = bamgen.write_realistic_bam(str(mine), ref, 4000, seed=seed)
    sb = port.write_realistic_bam(str(theirs), ref, 4000, seed=seed)
    assert mine.read_bytes() == theirs.read_bytes()
    assert dataclasses.asdict(sa) == dataclasses.asdict(sb)


@pytest.mark.parametrize("seed", [3, 2**62 - 1])
def test_records_hold_the_frozen_alignments(tmp_path, ref, seed):
    """A BAM of records.py decodes to the alignments of the frozen
    encoder's bytes for the same draw, and every record is STAR-shaped."""
    full, bare = str(tmp_path / "full.bam"), str(tmp_path / "bare.bam")
    n = records.write_bam(full, ref, 3000, seed, chunk_pairs=1000)
    hdr = bamgen._bam_header(ref)
    with open(bare, "wb") as fh:
        from portbench.frozen import bgzf

        bgzf.write_payload(fh, hdr)
        for lo in range(0, 3000, 1000):
            cols, _ = bamgen.realistic_columns(ref, 1000, seed=seed + lo, pid_offset=lo)
            bgzf.write_payload(fh, bamgen.encode_records(*cols))
        bgzf.close(fh)
    a, b = decode(full, ref.chroms), decode(bare, ref.chroms)
    assert a.n_records == b.n_records == n
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert (np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y), f.name
    payload = inflate(full)
    offs = record_offsets(payload, read_header(payload)[1])
    buf = np.frombuffer(payload, np.uint8)
    l_seq = buf[offs[:, None] + np.arange(20, 24)].copy().view("<i4").ravel()
    assert (l_seq == 100).all()
    assert 240 <= (len(payload) - len(hdr)) / n <= 270
    assert payload.count(b"NHC") == payload.count(b"nMC") == n


@pytest.mark.parametrize("name", ["chr21", "grch38"])
def test_config_map_sizes(name):
    """The sizes a configuration file states are those its map has."""
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as fh:
        cfg = json.load(fh)
    if name == "grch38":  # the annotation only: compiling it takes long here
        ex = genome.annotation(cfg["map"])
        assert len({e.chrom for e in ex}) == cfg["map_sizes"]["chromosomes"]
        assert len({e.gene_id for e in ex}) == cfg["map"]["genes"]
        return
    r = genome.make_map(cfg["map"])
    assert cfg["map_sizes"] == {"chromosomes": len(r.chroms), "introns": r.n_introns,
                                "measured_bases": r.mbs_size}


def test_gene_structure_follows_its_statistics():
    """The whole-genome annotation's medians and means sit near the
    published ones its configuration states."""
    with open(os.path.join(ROOT, "portbench", "configs", "grch38.json")) as fh:
        m = json.load(fh)["map"]
    ex = genome.annotation(m)
    by_tx: dict = {}
    for e in ex:
        if e.transcript_id.endswith(".t1"):
            by_tx.setdefault(e.transcript_id, []).append((e.start, e.end))
    n_ex = np.array([len(v) for v in by_tx.values()])
    introns = np.array([b[0] - a[1] for v in by_tx.values() for a, b in zip(v, v[1:])])
    assert abs(np.median(n_ex) - m["exons_per_gene"]["median"]) <= 1
    assert abs(n_ex.mean() / m["exons_per_gene"]["mean"] - 1) < 0.05
    assert abs(np.median(introns) / m["intron_bp"]["median"] - 1) < 0.05
    assert abs(introns.mean() / m["intron_bp"]["mean"] - 1) < 0.1
