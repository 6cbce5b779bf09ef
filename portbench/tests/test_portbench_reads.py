"""The reads of each traffic: a traffic without ``reads`` writes records.py's
BAMs from the same seeds as before; the long-read encoder
(reads/longread.py) writes what it drew, from the map's own transcripts,
in records that cross BGZF blocks."""

import json
import os
import struct

import numpy as np
import pytest

from portbench import genome, inputs, records
from portbench.frozen import semantics as S
from portbench.harness import HERE
from portbench.reads import longread as L
from portbench.reference.decode import decode, inflate, read_header, record_offsets
from portbench.tests.conftest import small_map


@pytest.fixture(scope="module")
def ref():
    return genome.make_map(small_map())


def _traffic(name: str, **over) -> dict:
    with open(os.path.join(HERE, "traffic", name + ".json")) as fh:
        return {**json.load(fh), **over}


@pytest.mark.parametrize("spc", [1, 2])
def test_paired_bytes_unchanged(tmp_path, ref, spc, monkeypatch):
    """make_inputs, for a traffic without ``reads``, writes the bytes of
    records.write_bam from the seeds it drew before read kinds existed."""
    monkeypatch.setattr(inputs, "WARMUP_PAIRS", 300)
    config = {"map": small_map(), "pairs_per_sample": 2000}
    seed = 2**31 + 17
    got, warm = inputs.make_inputs(str(tmp_path), ref, config, {"samples_per_call": spc}, seed)
    seeds = np.random.default_rng(seed).integers(0, 1 << 62, 2 * spc).tolist()
    made = [(inp, 2000, seeds[i]) for i, inp in enumerate(got)]
    made += [(w, 300, seeds[spc + i]) for i, w in enumerate(warm)]
    for inp, pairs, s in made:
        want = str(tmp_path / "want.bam")
        assert inp.records == records.write_bam(want, ref, pairs, s)
        with open(inp.path, "rb") as a, open(want, "rb") as b:
            assert a.read() == b.read()


def test_read_kind_by_name(tmp_path, ref, monkeypatch):
    """A traffic's ``reads`` names its module; its warm-up replaces the
    traffic's keys by WARMUP."""
    assert inputs.read_kind("longread") is L
    monkeypatch.setattr(L, "WARMUP", {"reads_per_sample": 200})
    config = {"map": small_map()}
    got, warm = inputs.make_inputs(str(tmp_path), ref, config,
                                   _traffic("longread", reads_per_sample=700), 5)
    assert got[0].records > 700 > warm[0].records > 200


def _chunks(ref, traffic, n, seed, chunk):
    tx = L.transcripts(small_map(), list(ref.chroms))
    p = L.gene_weights(traffic, tx.t1.size)
    out = []
    for lo in range(0, n, chunk):
        out.append(L.draw(tx, p, traffic, min(chunk, n - lo), np.random.default_rng([seed, lo])))
    return tx, out


@pytest.mark.parametrize("seed", [11, 2**40 + 3])
def test_longread_decodes_to_its_draw(tmp_path, ref, seed):
    """A long-read BAM decodes, by the reference's decode, to the blocks,
    junctions and fragments the encoder drew: exon chains of the map's
    transcripts, one retained intron in some reads, novel sites beside
    annotated ones; its records are minimap2-shaped and cross BGZF blocks."""
    tr = _traffic("longread", reads_per_sample=3000)
    bam = str(tmp_path / "lr.bam")
    n = L.write_bam(bam, ref, {"map": small_map()}, tr, seed, chunk_reads=1024)
    tx, als = _chunks(ref, tr, 3000, seed, 1024)
    assert n == sum(a.role.size for a in als)

    # what the reference admits: primaries at MIN_MAPQ or more, one fragment each
    adm = [(a.role == L.PRIMARY) & (a.mapq >= S.MIN_MAPQ) for a in als]
    d = decode(bam, ref.chroms)
    assert d.n_records == n
    assert np.array_equal(d.frag_start, np.concatenate([a.start[k] for a, k in zip(als, adm)]))
    assert np.array_equal(d.frag_end, np.concatenate([a.end[k] for a, k in zip(als, adm)]))
    assert np.array_equal(d.frag_strand, np.concatenate([a.reverse[k] for a, k in zip(als, adm)]))
    gk = [k[a.gap_aln] for a, k in zip(als, adm)]
    assert np.array_equal(d.gap_start, np.concatenate([a.gap_start[k] for a, k in zip(als, gk)]))
    assert np.array_equal(d.gap_end, np.concatenate([a.gap_end[k] for a, k in zip(als, gk)]))
    assert d.blk_start.size == d.frag_start.size + d.gap_start.size

    # the draw against the annotation: every junction an intron of its
    # transcript, or one end moved by 1..novel_shift_max_bp; retained
    # introns are the transcript's too, inside one aligned block
    last = np.r_[tx.first[1:], tx.ex_start.size]
    introns = {t: set(zip(tx.ex_end[lo:hi - 1].tolist(), tx.ex_start[lo + 1:hi].tolist()))
               for t, (lo, hi) in enumerate(zip(tx.first, last))}
    n_novel = n_ret = 0
    for a in als:
        for t, s, e, nov in zip(a.transcript[a.gap_aln], a.gap_start, a.gap_end, a.gap_novel):
            if nov:
                n_novel += 1
                assert any((s == x) != (e == y) and 1 <= abs(s - x) + abs(e - y)
                           <= tr["novel_shift_max_bp"] for x, y in introns[t])
            else:
                assert (s, e) in introns[t]
        for i in np.flatnonzero(a.retained_start >= 0):
            n_ret += 1
            s, e = a.retained_start[i], a.retained_end[i]
            assert (s, e) in introns[a.transcript[i]]
            assert e - s <= tr["retained_intron_max_bp"]
            mine = a.gap_aln == i
            assert not ((a.gap_start[mine] < e) & (a.gap_end[mine] > s)).any()
            assert a.start[i] < s and e < a.end[i]
    assert n_novel > 0 and n_ret > 0

    # the records: CIGAR operations, UUID names, minimap2's tags
    payload = inflate(bam)
    offs = record_offsets(payload, read_header(payload)[1])
    buf = np.frombuffer(payload, np.uint8)
    n_cig = buf[offs[:, None] + np.arange(16, 18)].copy().view("<u2").ravel()
    assert n_cig.max() >= 100
    ops = set()
    for o, k in zip(offs[:50].tolist(), n_cig[:50].tolist()):
        words = struct.unpack_from(f"<{k}I", payload, o + 36 + L._NAME_LEN)
        ops |= {w & 0xF for w in words}
    assert {L._M, L._I, L._D, L._N} <= ops and ops & {L._S, L._H}
    name = payload[offs[0] + 36:offs[0] + 36 + L._NAME_LEN]
    assert len(name) == 37 and name[-1] == 0 and name.count(b"-") == 4
    for tag in (b"NMS", b"msi", b"ASi", b"nnC", b"tsA", b"tpA", b"cmS", b"s1i", b"s2i", b"def",
                b"rlS"):
        assert payload.count(tag) >= n

    # BGZF blocks of htslib's size, and records across their boundaries
    with open(bam, "rb") as fh:
        raw = fh.read()
    sizes, at = [], 0
    while at < len(raw):
        bsize = struct.unpack_from("<H", raw, at + 16)[0] + 1
        sizes.append(struct.unpack_from("<I", raw, at + bsize - 4)[0])
        at += bsize
    ends = np.cumsum(sizes)
    assert max(sizes) == L._BLOCK
    rec_end = np.r_[offs[1:], len(payload)]
    crossing = np.searchsorted(ends, offs, "right") != np.searchsorted(ends, rec_end - 1, "right")
    assert crossing.sum() >= 10


def test_longread_bytes_do_not_depend_on_threads(tmp_path, ref, monkeypatch):
    tr = _traffic("longread", reads_per_sample=1500)
    paths = []
    for threads in (1, 4):
        monkeypatch.setattr(L, "THREADS", threads)
        paths.append(str(tmp_path / f"{threads}.bam"))
        L.write_bam(paths[-1], ref, {"map": small_map()}, tr, 99, chunk_reads=256)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
