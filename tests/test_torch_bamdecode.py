"""The port's native decoder (csrc/host/bamdecode.cpp) held to the JAX
package's native decoder and to the Python decoder, batch by batch.

The port's decoder parses records in its worker pool and leaves framing,
pairing and emission to the calling thread, so its source differs from the
JAX package's by design; what it emits must not.  On a paired-end, a
single-end and a long-read input (one record larger than a BGZF block
among them), through the file and the pipe path, at three batch sizes and
three pool sizes, every batch's columns and counts, every resume token and
the final counts are those of the JAX package's native decoder; the
columns, counts and the tokens it has are those of the Python decoder.
The decoder's own inflater reads every kind of deflate block; the pool
parses every record; and the decoder's smoke driver runs clean under
AddressSanitizer and ThreadSanitizer, on damaged input too.
"""

import dataclasses
import io
import os
import struct
import subprocess
import threading
import types
import zlib

import numpy as np
import pytest

from irfinder_tpu.io import bamgen as jbamgen
from irfinder_tpu.native import bamdecode as jbamdecode
from irfinder_tpu.synth import synth_ref
from irfinder_tpu_torch import synth
from irfinder_tpu_torch.engine import run_bam
from irfinder_tpu_torch.io import bamgen, bampy, bamwrite, bgzf
from irfinder_tpu_torch.io.batch import (
    BLOCKS_PER_FRAG, GAPS_PER_FRAG, LONGREAD_BLOCKS_PER_FRAG, LONGREAD_GAPS_PER_FRAG,
    all_arrays_of,
)
from irfinder_tpu_torch.native import CXX, SRC_DIR
from irfinder_tpu_torch.native import bamdecode
from portbench.harness import reader

COUNTS = ("n_blocks", "n_gaps", "n_frags", "n_reads", "cap_blocks", "cap_frags")
STATS = ("reads_total", "reads_admitted", "fragments", "pairs", "singles")
GEOMETRY = {
    "paired": (BLOCKS_PER_FRAG, GAPS_PER_FRAG),
    "single": (BLOCKS_PER_FRAG, GAPS_PER_FRAG),
    "longread": (LONGREAD_BLOCKS_PER_FRAG, LONGREAD_GAPS_PER_FRAG),
}


def _single_end_records(n: int, seed: int) -> list:
    """Single-end 100 bp reads with SEQ and QUAL, names all distinct; some
    spliced, some reverse, some that the admission rule drops."""
    rng = np.random.default_rng(seed)
    cigars = ["100M", "40M300N60M", "30M2I68M", "20M5D80M", "90M10S", "10M700N80M650N10M"]
    recs = []
    for i in range(n):
        kind = int(rng.integers(0, 12))
        cig = bamwrite.SimRead.parse_cigar(cigars[int(rng.integers(0, len(cigars)))])
        flag = 0x10 if rng.integers(0, 2) else 0
        mapq, ref_id = 60, int(rng.integers(0, 3))
        if kind == 0:
            mapq = 0
        elif kind == 1:
            flag |= 0x100
        elif kind == 2:
            flag, ref_id = 0x4, -1
        recs.append(bamwrite.encode_record(
            f"se{i:07d}", flag, ref_id, int(rng.integers(0, 900_000)), mapq, cig, seq_len=100))
    return recs


def _long_records(n: int, seed: int, big: int = 2) -> list:
    """Long single-end reads of 1.6-9.6 kb with SEQ and QUAL and 8-48
    exons, then ``big`` of ~100 kb with 64 exons: each larger than one BGZF
    block, so it straddles three."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n + big):
        is_big = i >= n
        n_ex = 64 if is_big else int(rng.integers(8, 49))
        exon = 1500 if is_big else int(rng.integers(200, 9600 // n_ex + 200))
        cig = []
        for e in range(n_ex):
            if e:
                cig.append((int(rng.integers(80, 3000)), "N"))
            cig.append((exon, "M"))
        seq = n_ex * exon
        recs.append(bamwrite.encode_record(
            f"lr{seed}_{i:06d}", 0x10 if rng.integers(0, 2) else 0, int(rng.integers(0, 3)),
            int(rng.integers(0, 500_000)), 60, cig, seq_len=seq))
    return recs


def _write(path: str, records: list) -> None:
    with open(path, "wb") as fh:
        bamwrite.write_bam(fh, ["chr1", "chr2", "chrX"], [2_000_000] * 3, records)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """{input: (path, chrom index)}: ~20,000 paired records (5 MB inflated),
    7,000 single-end records (1.7 MB), 300 long reads and two larger than a
    BGZF block between them (~3.6 MB)."""
    d = tmp_path_factory.mktemp("bamdecode")
    ref = synth_ref(n_genes=40)
    paired = str(d / "paired.bam")
    jbamgen.write_realistic_bam(paired, ref, n_pairs=10_000, seed=11)
    single, longread = str(d / "single.bam"), str(d / "longread.bam")
    _write(single, _single_end_records(7_000, seed=12))
    lr = _long_records(150, seed=13)
    _write(longread, lr[:75] + lr[-2:] + lr[75:-2] + _long_records(150, seed=14, big=0))
    pidx = {c: i for i, c in enumerate(ref.chroms)}
    sidx = {"chr1": 0, "chrX": 1}
    return {"paired": (paired, pidx), "single": (single, sidx), "longread": (longread, sidx)}


def _fd_decode(mod, path: str, ci: dict, **kw):
    """(header, batches, stats) of ``mod``'s decoder off an os.pipe that a
    thread writes the BAM into."""
    r_fd, w_fd = os.pipe()

    def writer():
        with open(path, "rb") as src, os.fdopen(w_fd, "wb") as w:
            w.write(src.read())

    t = threading.Thread(target=writer)
    t.start()
    try:
        h, b, st = mod.decode_bam_native_fd(r_fd, ci, **kw)
        b = list(b)
    finally:
        t.join()
        os.close(r_fd)
    return h, b, st


def _native(mod, source: str, inputs, cap: int, threads: int):
    name = source.removesuffix("_fd")
    path, ci = inputs[name]
    bpf, gpf = GEOMETRY[name]
    kw = dict(cap_frags=cap, n_threads=threads, blocks_per_frag=bpf, gaps_per_frag=gpf)
    if source.endswith("_fd"):
        return _fd_decode(mod, path, ci, **kw)
    h, b, st = mod.decode_bam_native(path, ci, **kw)
    return h, list(b), st


_PYTHON: dict = {}


def _python(name: str, inputs, cap: int):
    """The Python decoder's (header, batches, stats), once per input and cap."""
    if (name, cap) not in _PYTHON:
        path, ci = inputs[name]
        bpf, gpf = GEOMETRY[name]
        with open(path, "rb") as fh:
            h, b, st = bampy.decode_bam(fh, ci, cap_frags=cap, blocks_per_frag=bpf, gaps_per_frag=gpf)
            _PYTHON[name, cap] = (h, list(b), st)
    return _PYTHON[name, cap]


def _assert_batches_equal(got: list, want: list, tokens: str):
    """Counts and every column equal; ``tokens`` "all" (every batch's token
    equal) or "where_present" (where ``want`` carries one)."""
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        for k in COUNTS:
            assert getattr(a, k) == getattr(b, k), (i, k)
        wa = all_arrays_of(b)
        for k, v in all_arrays_of(a).items():
            np.testing.assert_array_equal(v, wa[k], err_msg=f"batch {i} column {k}")
        if tokens == "all" or b.resume_token is not None:
            assert a.resume_token == b.resume_token, f"batch {i} token"


@pytest.mark.parametrize("source", ["paired", "single", "longread", "paired_fd"])
@pytest.mark.parametrize("threads", [1, 2, 8])
@pytest.mark.parametrize("cap", [64, 256, 1 << 15])
def test_native_decoder_matches_jax_and_python(source, threads, cap, inputs):
    hp, port, sp = _native(bamdecode, source, inputs, cap, threads)
    hj, jax, sj = _native(jbamdecode, source, inputs, cap, threads)
    hy, py, sy = _python(source.removesuffix("_fd"), inputs, cap)
    for h in (hj, hy):
        assert (hp.ref_names, hp.ref_lengths) == (h.ref_names, h.ref_lengths)
        np.testing.assert_array_equal(hp.chrom_lut, h.chrom_lut)
    _assert_batches_equal(port, jax, tokens="all")
    _assert_batches_equal(port, py, tokens="where_present")
    assert all(b.resume_token for b in port)
    if cap == 64:
        assert len(port) > 3 and sum(b.resume_token is not None for b in py) > 2
    for k in STATS:
        assert getattr(sp, k) == getattr(sj, k) == getattr(sy, k), k
    assert sp.blocks_inflated == sj.blocks_inflated > 0
    assert sp.pool_records == sp.reads_total >= sp.reads_admitted > 0
    assert sp.pool_wait_s >= 0.0


def _reblock(src: str, dst: str, level: int, strategy: int, block: int) -> None:
    """``src``'s inflated stream written again as BGZF members of ``block``
    bytes, deflated at ``level`` with zlib's ``strategy``."""
    with open(src, "rb") as fh:
        payload = bgzf.read_all(fh)
    with open(dst, "wb") as out:
        for i in range(0, len(payload), block):
            chunk = payload[i : i + block]
            comp = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
            cdata = comp.compress(chunk) + comp.flush()
            bsize = 18 + len(cdata) + 8 - 1
            out.write(struct.pack("<4BIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 66, 67, 2, bsize))
            out.write(cdata)
            out.write(struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk)))
        bgzf.close(out)


@pytest.mark.parametrize("level,strategy,block", [
    (0, zlib.Z_DEFAULT_STRATEGY, 65000),  # stored blocks
    (1, zlib.Z_DEFAULT_STRATEGY, 65280),
    (9, zlib.Z_DEFAULT_STRATEGY, 60000),
    (6, zlib.Z_FIXED, 30000),
    (6, zlib.Z_HUFFMAN_ONLY, 65280),  # literals only
    (6, zlib.Z_RLE, 4099),  # distance-1 runs, many small members
    (6, zlib.Z_FILTERED, 65535),
])
def test_inflater_on_every_block_kind(level, strategy, block, inputs, tmp_path):
    """The decoder's own inflater gives the JAX package's decoder's batches
    whatever block kinds, code shapes and member sizes the deflate stream
    uses."""
    path, ci = inputs["single"]
    bam = str(tmp_path / "re.bam")
    _reblock(path, bam, level, strategy, block)
    _, port, sp = bamdecode.decode_bam_native(bam, ci, cap_frags=256, n_threads=3)
    _, jax, sj = jbamdecode.decode_bam_native(bam, ci, cap_frags=256, n_threads=3)
    _assert_batches_equal(list(port), list(jax), tokens="all")
    assert [getattr(sp, k) for k in STATS] == [getattr(sj, k) for k in STATS]
    assert sp.blocks_inflated == sj.blocks_inflated > 0


@pytest.mark.parametrize("use_native", [True, False])
def test_pool_counters(use_native, tmp_path):
    """A native decode's pool parses every record (RunMetrics'
    decode_pool_records = reads_total); both counters stay 0 from the Python
    decoder; decode.pool_wait_share reads them, and nothing without them or
    without decode time."""
    ref = synth.synth_ref(n_genes=24, chrom_len=1_500_000)
    bam = str(tmp_path / "x.bam")
    bamgen.write_realistic_bam(bam, ref, n_pairs=1500, seed=9)
    m = run_bam(ref, bam, str(tmp_path / "out"), cap_frags=256, use_native=use_native, device="cpu")
    assert m.reads_total > 3000 and m.decode_s > 0
    share = reader("decode.pool_wait_share")(types.SimpleNamespace(completed=[(0, m), (1, m)]))
    if use_native:
        assert m.decode_pool_records == m.reads_total
        assert 0.0 <= m.decode_pool_wait_s <= m.decode_s
        assert 0.0 <= share <= 100.0
    else:
        assert (m.decode_pool_records, m.decode_pool_wait_s, share) == (0, 0.0, 0.0)
    idle = types.SimpleNamespace(completed=[(0, dataclasses.replace(m, decode_s=0.0))])
    assert reader("decode.pool_wait_share")(idle) is None
    bare = types.SimpleNamespace(completed=[(0, types.SimpleNamespace(decode_s=1.0))])
    assert reader("decode.pool_wait_share")(bare) is None


def _sanitizer_build(kind: str, out: str) -> subprocess.CompletedProcess:
    flags = ["-O1", "-g", "-std=c++17", "-pthread", f"-fsanitize={kind}", "-DBAMDECODE_MAIN"]
    return subprocess.run(
        [CXX, *flags, "-o", out, os.path.join(SRC_DIR, "bamdecode.cpp")],
        capture_output=True, text=True,
    )


@pytest.mark.parametrize("kind", ["address", "thread"])
def test_sanitizer_smoke(kind, tmp_path):
    """The decoder's smoke driver, built with the sanitizer, decodes a
    random BAM at 8 threads on the file and the pipe path: no report, and
    the same checksums (columns and tokens) on both."""
    from test_oracle import random_bam_bytes

    exe = str(tmp_path / f"bamdecode_{kind}")
    r = _sanitizer_build(kind, exe)
    if r.returncode != 0:
        pytest.skip(f"sanitizer build unavailable: {r.stderr[-200:]}")
    bam = tmp_path / "s.bam"
    raw = random_bam_bytes(seed=3, n_frags=3000)
    payload = bgzf.read_all(io.BytesIO(raw))
    with open(bam, "wb") as fh:  # small BGZF blocks: many chunks and straddles
        bgzf.write_payload(fh, payload, block_size=7000)
        bgzf.close(fh)
    p = subprocess.run([exe, str(bam), "8"], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-800:]
    assert "SUMMARY" not in p.stderr, p.stderr[-2000:]
    with open(bam, "rb") as fh:
        ps = subprocess.run([exe, "-", "8"], stdin=fh, capture_output=True, text=True, timeout=300)
    assert ps.returncode == 0, ps.stderr[-800:]
    assert "SUMMARY" not in ps.stderr, ps.stderr[-2000:]
    assert ps.stdout == p.stdout and "pool_records=" in p.stdout
    fields = dict(kv.split("=") for kv in p.stdout.split())
    assert int(fields["pool_records"]) == int(fields["total"]) > 3000
    # damaged deflate data: an error or a decode, never a bad access
    raw = bam.read_bytes()
    rng = np.random.default_rng(4)
    for k in range(4):
        bad = bytearray(raw)
        for at in rng.integers(20, len(raw) - 40, 3 + k):
            bad[at] ^= 1 << int(rng.integers(0, 8))
        (tmp_path / "bad.bam").write_bytes(bytes(bad))
        pb = subprocess.run([exe, str(tmp_path / "bad.bam"), "8"], capture_output=True, text=True, timeout=300)
        assert pb.returncode in (0, 1) and "SUMMARY" not in pb.stderr, pb.stderr[-2000:]
