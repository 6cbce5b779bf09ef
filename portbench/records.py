"""The benchmark's BAMs: the paired-end read mix of the frozen generator
(frozen/bamgen.realistic_columns), encoded whole, as STAR writes an
alignment of 2 x 100 bp reads.

Each record carries, beyond what the frozen encoder writes:

* a 39-character Illumina read name (``<instrument>:<run>:<flowcell>:
  <lane>:<tile>:<x>:<y>``), the same for both mates of a pair;
* SEQ: 100 bases (every CIGAR shape of the mix has a query of 100), drawn
  from the seed, four bits a base;
* QUAL: 100 qualities on the four bins of Illumina's NovaSeq binning (2,
  12, 23, 37), drawn from the seed;
* STAR's standard attributes (``--outSAMattributes Standard``): NH, HI,
  AS and nM, each as an unsigned byte (``C``).  A pair with a secondary
  alignment has NH 2, and its secondary record HI 2; nM is the pair's
  mismatches and AS = 198 - 2 nM.

Blocks are BGZF at level 1, STAR's default ``--outBAMcompression``,
compressed on a few threads.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .frozen import bamgen, bgzf

_M, _N, _S = 0, 3, 4
_NAME = b"A00217:285:HVKJFDSXY:1:1101:"  # then <x>:<y>, 5 digits each
_NAME_LEN = len(_NAME) + 11 + 1  # with its NUL
_READ = 100
_FIXED = 36  # block_size .. tlen
_MAX_CIGAR = 5
_TAGS = 16  # NH, HI, AS, nM: 2 + 1 + 1 bytes each
_WIDTH = _FIXED + _NAME_LEN + 4 * _MAX_CIGAR + _READ // 2 + _READ + _TAGS
_SHAPE_NOPS = np.array([1, 2, 3, 5], np.int64)
#: BAM's 4-bit codes of A, C, G, T
_BASES = np.array([1, 2, 4, 8], np.uint8)
#: NovaSeq's quality bins and the share of bases in each
_QBINS = np.array([2, 12, 23, 37], np.uint8)
_QSHARE = (0.02, 0.03, 0.07, 0.88)
_LEVEL = 1
_BLOCK = 60000
THREADS = min(8, os.cpu_count() or 1)

_FIXED_DT = np.dtype([
    ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
    ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"), ("n_cigar", "<u2"),
    ("flag", "<u2"), ("l_seq", "<i4"), ("next_ref", "<i4"), ("next_pos", "<i4"),
    ("tlen", "<i4"),
])


def _byte_lut(values: np.ndarray, shares) -> np.ndarray:
    """256 entries: a uniform random byte mapped to ``values`` at ``shares``."""
    edges = np.rint(np.cumsum(shares) * 256).astype(np.int64)
    return values[np.searchsorted(edges, np.arange(256), side="right")]


#: a random byte -> one packed byte of two bases
_SEQ_LUT = ((_BASES[np.arange(256) & 3] << 4) | _BASES[(np.arange(256) >> 2) & 3]).astype(np.uint8)
_QUAL_LUT = _byte_lut(_QBINS, _QSHARE)


def _digits(v: np.ndarray, width: int) -> np.ndarray:
    out = np.empty((v.size, width), np.uint8)
    t = v.astype(np.int64)
    for k in range(width - 1, -1, -1):
        t, r = np.divmod(t, 10)
        out[:, k] = r + ord("0")
    return out


def encode(cols: tuple, rng: np.random.Generator) -> bytes:
    """The records of ``cols`` (realistic_columns' columns) as BAM bytes."""
    shape, rid, pos, flag, mapq, pid, g1, g2 = cols
    n = shape.size
    nops = _SHAPE_NOPS[shape]
    m = np.zeros((n, _WIDTH), np.uint8)

    fixed = np.zeros(n, _FIXED_DT)
    fixed["block_size"] = _WIDTH - 4 - 4 * (_MAX_CIGAR - nops)
    fixed["ref_id"] = rid
    fixed["pos"] = pos
    fixed["l_read_name"] = _NAME_LEN
    fixed["mapq"] = mapq
    fixed["n_cigar"] = nops
    fixed["flag"] = flag
    fixed["l_seq"] = _READ
    fixed["next_ref"] = -1
    fixed["next_pos"] = -1
    m[:, :_FIXED] = fixed.view(np.uint8).reshape(n, _FIXED)

    at = _FIXED
    m[:, at:at + len(_NAME)] = np.frombuffer(_NAME, np.uint8)
    at += len(_NAME)
    m[:, at:at + 5] = _digits(pid // 100000 % 100000, 5)
    m[:, at + 5] = ord(":")
    m[:, at + 6:at + 11] = _digits(pid % 100000, 5)
    at += 12  # the NUL is already there

    cig = np.zeros((n, _MAX_CIGAR), "<u4")
    gap1 = (g1.astype(np.uint32) << 4) | _N
    gap2 = (g2.astype(np.uint32) << 4) | _N
    s0, s1, s2, s3 = (shape == k for k in range(4))
    cig[s0, 0] = (_READ << 4) | _M
    cig[s1, 0], cig[s1, 1] = (12 << 4) | _S, (88 << 4) | _M
    cig[s2, 0], cig[s2, 1], cig[s2, 2] = (50 << 4) | _M, gap1[s2], (50 << 4) | _M
    cig[s3, 0], cig[s3, 1], cig[s3, 2] = (30 << 4) | _M, gap1[s3], (40 << 4) | _M
    cig[s3, 3], cig[s3, 4] = gap2[s3], (30 << 4) | _M
    m[:, at:at + 4 * _MAX_CIGAR] = cig.view(np.uint8).reshape(n, 4 * _MAX_CIGAR)
    at += 4 * _MAX_CIGAR

    m[:, at:at + _READ // 2] = _SEQ_LUT[np.frombuffer(rng.bytes(n * _READ // 2), np.uint8)
                                        ].reshape(n, _READ // 2)
    at += _READ // 2
    m[:, at:at + _READ] = _QUAL_LUT[np.frombuffer(rng.bytes(n * _READ), np.uint8)].reshape(n, _READ)
    at += _READ

    # STAR's tags: per pair NH (2 with a secondary alignment), nM, AS; HI per record
    p = pid - pid.min()
    secondary = (flag & 0x100) != 0
    has_sec = np.zeros(int(p.max()) + 1 if n else 0, bool)
    has_sec[p[secondary]] = True
    mism = rng.choice(np.arange(4, dtype=np.uint8), size=has_sec.size, p=[0.70, 0.20, 0.07, 0.03])
    for tag, v in ((b"NHC", 1 + has_sec[p]), (b"HIC", 1 + secondary),
                   (b"ASC", 198 - 2 * mism[p].astype(np.int64)), (b"nMC", mism[p])):
        m[:, at:at + 3] = np.frombuffer(tag, np.uint8)
        m[:, at + 3] = v
        at += 4
    assert at == _WIDTH

    keep = np.ones((n, _WIDTH), bool)
    cig0 = _FIXED + _NAME_LEN
    keep[:, cig0:cig0 + 4 * _MAX_CIGAR] = (
        np.arange(4 * _MAX_CIGAR)[None, :] < 4 * nops[:, None])
    return m[keep].tobytes()


def _block(payload: bytes) -> bytes:
    """One BGZF block of ``payload`` (the layout of frozen/bgzf.write_block)."""
    comp = zlib.compressobj(_LEVEL, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    header = struct.pack("<4BIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 66, 67, 2,
                         18 + len(cdata) + 8 - 1)
    return header + cdata + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload))


def _chunk(ref, n: int, seed: int, lo: int) -> tuple:
    """(BGZF blocks, records) of pairs ``lo`` .. ``lo + n`` of the sample
    of ``seed``: the frozen writer's draw of that chunk, encoded whole."""
    cols, st = bamgen.realistic_columns(ref, n, seed=seed + lo, pid_offset=lo)
    data = encode(cols, np.random.default_rng([seed, lo]))
    blocks = b"".join(_block(data[i:i + _BLOCK]) for i in range(0, len(data), _BLOCK))
    return blocks, st.n_records


def write_bam(path: str, ref, n_pairs: int, seed: int, chunk_pairs: int = 1 << 17) -> int:
    """A BAM of ``n_pairs`` pairs of the read mix from ``seed`` at ``path``;
    returns its number of records.  Chunks are made on THREADS threads,
    each from its own seed, so the bytes do not depend on their order."""
    records = 0
    los = range(0, n_pairs, chunk_pairs)
    with open(path, "wb") as fh, ThreadPoolExecutor(THREADS) as ex:
        fh.write(_block(bamgen._bam_header(ref)))
        for blocks, n in ex.map(lambda lo: _chunk(ref, min(chunk_pairs, n_pairs - lo), seed, lo), los):
            fh.write(blocks)
            records += n
        fh.write(bgzf.BGZF_EOF)
    return records
