"""Plain NumPy BAM decode for the benchmark's reference: BGZF -> records ->
admitted reads -> fragments, as whole-file column arrays.

Written for the benchmark from IRFinder's BAM2blocks rules as the port
states them (semantics.py), independent of the port's decoders:

* admission: a record is dropped when FLAG & FLAG_DROP_MASK, MAPQ <
  MIN_MAPQ, refID < 0 or no CIGAR operation;
* CIGAR: a gap operation (N) of at least MIN_GAP_AS_JUNCTION bases closes
  the open aligned block and is a splice gap; any other operation that
  consumes the reference opens or extends a block; I/S/H/P do neither;
* mates: admitted reads pair by name adjacency in file order (a run of k
  equal names makes k // 2 pairs and, when k is odd, one single);
* a pair whose mates lie on different references is two fragments;
* fragment strand: read1's alignment strand (read2 contributes the
  opposite); every block and gap of a fragment carries the strand of its
  first read.

Batching does not enter: every counter is a sum over fragments.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..frozen import semantics as S

#: threads that inflate the BGZF blocks (the reference runs after the window)
THREADS = min(8, os.cpu_count() or 1)

#: the fixed 36 bytes that open a record (block_size included)
_FIXED = np.dtype([
    ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
    ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"), ("n_cigar", "<u2"),
    ("flag", "<u2"), ("l_seq", "<i4"), ("next_ref", "<i4"), ("next_pos", "<i4"),
    ("tlen", "<i4"),
])


@dataclasses.dataclass
class Decoded:
    """One BAM decoded whole.  Blocks, gaps and fragments carry the
    compiled chromosome id (-1: a reference the map does not hold)."""

    ref_names: list
    n_records: int
    blk_chrom: np.ndarray
    blk_start: np.ndarray
    blk_end: np.ndarray
    blk_strand: np.ndarray
    gap_chrom: np.ndarray
    gap_start: np.ndarray
    gap_end: np.ndarray
    gap_strand: np.ndarray
    frag_chrom: np.ndarray
    frag_refid: np.ndarray
    frag_start: np.ndarray
    frag_end: np.ndarray
    frag_strand: np.ndarray


def _block_spans(raw: bytes) -> list:
    """(start, end) of each BGZF block's deflated data in ``raw``, and the
    block's end: [(data start, data end, block end), ...]."""
    spans = []
    off, n = 0, len(raw)
    while off < n:
        if n - off < 18 or raw[off:off + 4] != b"\x1f\x8b\x08\x04":
            raise ValueError("not a BGZF block (bad gzip magic / FEXTRA)")
        (xlen,) = struct.unpack_from("<H", raw, off + 10)
        at, bsize = off + 12, None
        while at + 4 <= off + 12 + xlen:
            si1, si2, slen = raw[at], raw[at + 1], struct.unpack_from("<H", raw, at + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                (bsize,) = struct.unpack_from("<H", raw, at + 4)
            at += 4 + slen
        if bsize is None:
            raise ValueError("BGZF BC subfield missing")
        end = off + bsize + 1
        if end > n:
            raise ValueError("truncated BGZF block body")
        spans.append((off + 12 + xlen, end - 8, end))
        off = end
    return spans


def inflate(path: str) -> bytes:
    """The BAM's payload: every BGZF block inflated (on THREADS threads)
    and its CRC and length checked."""
    with open(path, "rb") as fh:
        raw = fh.read()

    def one(span: tuple) -> bytes:
        a, b, end = span
        payload = zlib.decompress(raw[a:b], wbits=-15)
        crc, isize = struct.unpack_from("<II", raw, b)
        if len(payload) != isize or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise ValueError("BGZF block CRC/length mismatch (corrupt block)")
        return payload

    with ThreadPoolExecutor(THREADS) as ex:
        return b"".join(ex.map(one, _block_spans(raw), chunksize=64))


def read_header(payload: bytes) -> tuple:
    """(reference names, offset of the first record)."""
    if payload[:4] != b"BAM\x01":
        raise ValueError("not a BAM file (missing BAM\\1 magic)")
    (l_text,) = struct.unpack_from("<i", payload, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", payload, off)
    off += 4
    names = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", payload, off)
        names.append(payload[off + 4: off + 4 + l_name - 1].decode())
        off += 4 + l_name + 4
    return names, off


def record_offsets(payload: bytes, off: int) -> np.ndarray:
    """The offset of every record: a walk over block_size."""
    n = len(payload)
    unpack = struct.Struct("<i").unpack_from
    out = []
    append = out.append
    while off < n:
        append(off)
        (bs,) = unpack(payload, off)
        if bs < 32:
            raise ValueError("corrupt BAM record (block_size < 32)")
        off += 4 + bs
    if off != n:
        raise ValueError("truncated BAM record")
    return np.array(out, np.int64)


def _gather(buf: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """(n, width) bytes of ``buf`` at each start (a copy of those bytes
    only, through a sliding-window view)."""
    return np.lib.stride_tricks.sliding_window_view(buf, width)[starts]


def _same_name_as_next(buf: np.ndarray, off: np.ndarray, l_name: np.ndarray) -> np.ndarray:
    """same[i]: read i+1 has read i's name (the NUL excluded)."""
    n = off.size
    if n < 2:
        return np.zeros(max(n - 1, 0), bool)
    width = int(l_name.max())
    names = _gather(buf, off + 36, width)
    names = np.where(np.arange(width)[None, :] < (l_name[:, None] - 1), names, 0)
    return (l_name[1:] == l_name[:-1]) & (names[1:] == names[:-1]).all(axis=1)


def _segments(keys: np.ndarray) -> np.ndarray:
    """Start index of each run of equal ``keys`` (keys sorted by run)."""
    if keys.size == 0:
        return np.zeros(0, np.int64)
    new = np.ones(keys.size, bool)
    new[1:] = keys[1:] != keys[:-1]
    return np.flatnonzero(new)


def decode(path: str, chroms: list) -> Decoded:
    """Decode the BAM at ``path`` against a map whose chromosomes are
    ``chroms`` (in the map's order)."""
    payload = inflate(path)
    ref_names, off0 = read_header(payload)
    chrom_of = {c: i for i, c in enumerate(chroms)}
    lut = np.array([chrom_of.get(nm, -1) for nm in ref_names] + [-1], np.int32)
    buf = np.frombuffer(payload, np.uint8)
    offs = record_offsets(payload, off0)
    n_records = int(offs.size)
    fixed = _gather(buf, offs, 36).view(_FIXED).reshape(n_records)

    flag = fixed["flag"].astype(np.int64)
    keep = (
        ((flag & S.FLAG_DROP_MASK) == 0) & (fixed["mapq"] >= S.MIN_MAPQ)
        & (fixed["ref_id"] >= 0) & (fixed["n_cigar"] > 0)
    )
    adm = np.flatnonzero(keep)
    off = offs[adm]
    flag = flag[adm]
    ref_id = fixed["ref_id"][adm].astype(np.int64)
    pos = fixed["pos"][adm].astype(np.int64)
    l_name = fixed["l_read_name"][adm].astype(np.int64)
    n_cig = fixed["n_cigar"][adm].astype(np.int64)
    n = adm.size

    # ---- fragments: name adjacency, then one fragment per reference -----
    same = _same_name_as_next(buf, off, l_name)
    run_start = np.ones(n, bool)
    run_start[1:] = ~same
    run_id = np.cumsum(run_start) - 1
    first_of_run = np.flatnonzero(run_start)
    k = np.arange(n) - first_of_run[run_id]  # position within its run
    run_len = np.diff(np.append(first_of_run, n))[run_id]
    paired_head = (k % 2 == 0) & (k + 1 < run_len)
    mate = np.zeros(n, bool)  # the second read of a pair
    mate[1:] = paired_head[:-1]
    # a fragment id per read: a mate on its head's reference joins the
    # head's fragment, every other read opens its own
    joins = mate.copy()
    joins[1:] &= ref_id[1:] == ref_id[:-1]
    frag_of = np.cumsum(~joins) - 1
    n_frags = int(frag_of[-1]) + 1 if n else 0

    rev = (flag & 0x10) != 0
    read_strand = np.where((flag & 0x1 == 0) | (flag & 0x40 != 0), rev, ~rev).astype(np.int64)
    frag_first = np.flatnonzero(~joins)
    frag_strand = read_strand[frag_first]
    frag_refid = ref_id[frag_first]
    frag_chrom = lut[np.where(frag_refid < len(ref_names), frag_refid, len(ref_names))]
    strand_of_read = frag_strand[frag_of]
    chrom_of_read = frag_chrom[frag_of]

    # ---- CIGAR: blocks and gaps -----------------------------------------
    n_ops = int(n_cig.sum())
    read_of_op = np.repeat(np.arange(n), n_cig)
    op_first = np.cumsum(n_cig) - n_cig
    op_k = np.arange(n_ops) - op_first[read_of_op]
    at = np.repeat(off + 36 + l_name, n_cig) + 4 * op_k
    word = _gather(buf, at, 4).view("<u4").reshape(n_ops).astype(np.int64)
    op, ln = word & 0xF, word >> 4
    if n_ops and op.max() >= len(S.CIGAR_CONSUMES_REF):
        raise ValueError("CIGAR operation code out of range")
    is_gap = np.asarray(S.CIGAR_IS_GAP)[op] & (ln >= S.MIN_GAP_AS_JUNCTION)
    extends = ~is_gap & np.asarray(S.CIGAR_CONSUMES_REF)[op]
    adv = np.where(is_gap | extends, ln, 0)
    csum = np.cumsum(adv)
    before = pos[read_of_op] + csum - adv - (csum - adv)[op_first][read_of_op]
    after = before + adv

    g = np.flatnonzero(is_gap)
    gap_read = read_of_op[g]
    # blocks: the extending operations between two gaps of one read
    seg = np.cumsum(is_gap) + read_of_op  # changes at every gap and read
    e = np.flatnonzero(extends)
    bstart = _segments(seg[e])
    blk_read = read_of_op[e][bstart]
    blk_start = before[e][bstart]
    blk_end = np.maximum.reduceat(after[e], bstart) if e.size else np.zeros(0, np.int64)

    # fragment spans over their blocks (0, 0 without a block)
    blk_frag = frag_of[blk_read]
    fs = np.zeros(n_frags, np.int64)
    fe = np.zeros(n_frags, np.int64)
    has = np.zeros(n_frags, bool)
    if blk_frag.size:
        lo = np.full(n_frags, np.iinfo(np.int64).max)
        hi = np.full(n_frags, np.iinfo(np.int64).min)
        np.minimum.at(lo, blk_frag, blk_start)
        np.maximum.at(hi, blk_frag, blk_end)
        has[blk_frag] = True
        fs[has], fe[has] = lo[has], hi[has]

    return Decoded(
        ref_names=ref_names,
        n_records=n_records,
        blk_chrom=chrom_of_read[blk_read],
        blk_start=blk_start,
        blk_end=blk_end,
        blk_strand=strand_of_read[blk_read],
        gap_chrom=chrom_of_read[gap_read],
        gap_start=before[g],
        gap_end=after[g],
        gap_strand=strand_of_read[gap_read],
        frag_chrom=frag_chrom,
        frag_refid=frag_refid,
        frag_start=fs,
        frag_end=fe,
        frag_strand=frag_strand,
    )
