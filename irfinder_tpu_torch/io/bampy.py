"""Pure-Python BAM decoder: BGZF -> records -> fragments -> PackedBatch.

Behavioral reference for the native C++ decoder (csrc/host/bamdecode.cpp):
both must produce identical PackedBatch streams.
Reconstruction of the reference's BAM2blocks stage (SURVEY.md §2 rows 7-8,
historical src/irfinder/BAM2blocks.cpp [R]):

* admission: drop reads with FLAG & semantics.FLAG_DROP_MASK or
  MAPQ < semantics.MIN_MAPQ,
* CIGAR: M/D/=/X extend the current aligned block; N closes it and records a
  splice gap; I/S/H/P consume no reference (semantics.CIGAR_*),
* mate pairing: by read-name adjacency over *admitted* reads in file order
  (aligner output order; the reference requires name-collated input,
  SURVEY.md §3.3),
* fragment strand: read1's alignment strand (read2 contributes the opposite),
  giving one strand label per fragment.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import BinaryIO, Iterator

import numpy as np

from .. import semantics as S
from . import bgzf
from .batch import BLOCKS_PER_FRAG, GAPS_PER_FRAG, MIN_CAP_UNITS, PackedBatch


@dataclasses.dataclass
class BamHeader:
    text: str
    ref_names: list
    ref_lengths: list
    #: refid -> compiled chrom id LUT (int32, -1 unknown), filled by the
    #: decoders
    chrom_lut: object = None


@dataclasses.dataclass
class DecodedRead:
    name: str
    flag: int
    ref_id: int
    strand: int  # fragment-strand contribution (read1-equivalent), 0/1
    blocks: list  # [(start, end)]
    gaps: list  # [(start, end)]


@dataclasses.dataclass
class DecodeStats:
    reads_total: int = 0
    reads_admitted: int = 0
    fragments: int = 0
    pairs: int = 0
    singles: int = 0
    #: BGZF blocks inflated this run, not restored from a resume token (the
    #: native decoder's count): after a resume only the rest are inflated
    blocks_inflated: int = 0
    #: records parsed by the native decoder's worker pool, and the seconds its
    #: ordering thread waited on the pool (0 from this decoder)
    pool_records: int = 0
    pool_wait_s: float = 0.0


def read_header(payload: memoryview, offset: int = 0) -> tuple[BamHeader, int]:
    """Parse the BAM header of an inflated payload at ``offset``; returns the
    header and the offset of the first record."""
    if bytes(payload[offset : offset + 4]) != b"BAM\x01":
        raise ValueError("not a BAM file (missing BAM\\1 magic)")
    offset += 4
    (l_text,) = struct.unpack_from("<i", payload, offset)
    offset += 4
    text = bytes(payload[offset : offset + l_text]).rstrip(b"\0").decode()
    offset += l_text
    (n_ref,) = struct.unpack_from("<i", payload, offset)
    offset += 4
    names, lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", payload, offset)
        offset += 4
        names.append(bytes(payload[offset : offset + l_name - 1]).decode())
        offset += l_name
        (l_ref,) = struct.unpack_from("<i", payload, offset)
        offset += 4
        lengths.append(l_ref)
    return BamHeader(text, names, lengths), offset


def _decode_read(payload: memoryview, off: int) -> tuple[DecodedRead | None, int, int]:
    """Returns (read-or-None-if-filtered, new_offset, admitted_flag_ignored)."""
    (block_size,) = struct.unpack_from("<i", payload, off)
    body_end = off + 4 + block_size
    (
        ref_id,
        pos,
        l_read_name,
        mapq,
        _bin,
        n_cigar,
        flag,
        l_seq,
        _next_ref,
        _next_pos,
        _tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", payload, off + 4)
    o = off + 4 + 32
    name = bytes(payload[o : o + l_read_name - 1]).decode()
    o += l_read_name
    if flag & S.FLAG_DROP_MASK or mapq < S.MIN_MAPQ or ref_id < 0 or n_cigar == 0:
        return None, body_end, 0
    cigar = struct.unpack_from(f"<{n_cigar}I", payload, o)
    blocks, gaps = [], []
    cur = pos
    blk_start = pos
    open_block = False
    for c in cigar:
        op, ln = c & 0xF, c >> 4
        if S.CIGAR_IS_GAP[op] and ln >= S.MIN_GAP_AS_JUNCTION:
            if open_block:
                blocks.append((blk_start, cur))
                open_block = False
            gaps.append((cur, cur + ln))
            cur += ln
            blk_start = cur
        elif S.CIGAR_CONSUMES_REF[op]:
            if not open_block:
                blk_start = cur
                open_block = True
            cur += ln
    if open_block:
        blocks.append((blk_start, cur))
    read_rev = 1 if flag & 0x10 else 0
    frag_strand = read_rev if (not flag & 0x1 or flag & 0x40) else 1 - read_rev
    return DecodedRead(name, flag, ref_id, frag_strand, blocks, gaps), body_end, 1


def iter_reads(payload: bytes) -> Iterator[DecodedRead | None]:
    """Yield one read per record after the header of an inflated payload
    (None for a record the admission rule filters)."""
    mv = memoryview(payload)
    _, off = read_header(mv)
    n = len(payload)
    while off < n:
        read, off, _ = _decode_read(mv, off)
        yield read


class FragmentAssembler:
    """Name-adjacency mate pairing over admitted reads."""

    def __init__(self):
        self.pending: DecodedRead | None = None

    def push(self, read: DecodedRead) -> list:
        """Returns zero or more completed fragments: [(reads...)]."""
        out = []
        if self.pending is not None:
            if self.pending.name == read.name:
                out.append((self.pending, read))
                self.pending = None
                return out
            out.append((self.pending,))
        self.pending = read
        return out

    def flush(self) -> list:
        out = [(self.pending,)] if self.pending is not None else []
        self.pending = None
        return out


class BatchBuilder:
    """Accumulates fragments into fixed-capacity PackedBatches; fragments never
    split across batches (mate-pair carry-over, SURVEY.md §7.3 item 4)."""

    def __init__(
        self,
        chrom_of_refid: np.ndarray,
        cap_frags: int = 1 << 15,
        blocks_per_frag: int = BLOCKS_PER_FRAG,
        gaps_per_frag: int = GAPS_PER_FRAG,
    ):
        # sized so typical paired fragments (<=2 blocks+<=1 gap per mate) fit;
        # long-read streams pass the LONGREAD_* geometry (io/batch.py)
        self.cap_frags = cap_frags
        self.cap_blocks = max(cap_frags * blocks_per_frag, MIN_CAP_UNITS)
        self.cap_gaps = max(cap_frags * gaps_per_frag, MIN_CAP_UNITS)
        self.chrom_of_refid = chrom_of_refid  # int32 LUT, -1 = not in ref
        self.reset()

    def reset(self):
        self.batch = PackedBatch.empty(self.cap_blocks, self.cap_gaps, self.cap_frags)

    def _full(self, nb: int, ng: int, nf: int) -> bool:
        b = self.batch
        return (
            b.n_blocks + nb > self.cap_blocks
            or b.n_gaps + ng > self.cap_gaps
            or b.n_frags + nf > self.cap_frags
        )

    def add_fragment(self, reads: tuple) -> PackedBatch | None:
        """Add one fragment; returns a completed batch if this one forced a flush."""
        # group mates by ref_id: mates on different chroms count as two fragments
        by_ref: dict = {}
        for r in reads:
            by_ref.setdefault(r.ref_id, []).append(r)
        nb = sum(len(r.blocks) for r in reads)
        ng = sum(len(r.gaps) for r in reads)
        nf = len(by_ref)
        if nb > self.cap_blocks or ng > self.cap_gaps:
            raise ValueError(
                f"fragment with {nb} blocks / {ng} gaps exceeds batch capacity "
                f"({self.cap_blocks}/{self.cap_gaps}); corrupt CIGAR?"
            )
        done = None
        if self._full(nb, ng, nf):
            done = self.finish()
        b = self.batch
        for ref_id, rs in by_ref.items():
            chrom = int(self.chrom_of_refid[ref_id]) if ref_id < len(self.chrom_of_refid) else -1
            strand = rs[0].strand
            span_lo, span_hi = None, None
            nblk = 0
            for r in rs:
                for (s, e) in r.blocks:
                    nblk += 1
                    i = b.n_blocks
                    b.blk_chrom[i] = chrom
                    b.blk_start[i] = s
                    b.blk_end[i] = e
                    b.blk_strand[i] = strand
                    b.n_blocks += 1
                    span_lo = s if span_lo is None else min(span_lo, s)
                    span_hi = e if span_hi is None else max(span_hi, e)
                for (s, e) in r.gaps:
                    i = b.n_gaps
                    b.gap_chrom[i] = chrom
                    b.gap_start[i] = s
                    b.gap_end[i] = e
                    b.gap_strand[i] = strand
                    b.n_gaps += 1
            i = b.n_frags
            b.frag_chrom[i] = chrom
            b.frag_refid[i] = ref_id
            b.frag_start[i] = span_lo if span_lo is not None else 0
            b.frag_end[i] = span_hi if span_hi is not None else 0
            b.frag_strand[i] = strand
            b.frag_nblk[i] = nblk
            b.n_frags += 1
        b.n_reads += len(reads)
        return done

    def finish(self) -> PackedBatch:
        done = self.batch
        self.reset()
        return done


class StreamReader:
    """Incremental BGZF -> logical-byte-stream reader with a bounded rolling
    buffer: only ~one BGZF block (64KiB) plus one partial record is ever
    resident, so counting off a live aligner pipe genuinely overlaps
    alignment.  tell() reports the logical (inflated-stream) offset of the
    parse cursor, the unit the checkpoint/resume layer records."""

    def __init__(self, fh: BinaryIO):
        self._it = bgzf.iter_blocks(fh)
        self._buf = b""
        self.pos = 0  # parse cursor within _buf
        self.base = 0  # logical offset of _buf[0] in the inflated stream

    def ensure(self, n: int) -> bool:
        """At least n bytes available at the cursor; False at clean EOF."""
        while len(self._buf) - self.pos < n:
            try:
                blk = next(self._it)
            except StopIteration:
                return False
            if self.pos:
                self.base += self.pos
                self._buf = self._buf[self.pos :] + blk
                self.pos = 0
            else:
                self._buf += blk
        return True

    def view(self) -> memoryview:
        return memoryview(self._buf)

    def tell(self) -> int:
        return self.base + self.pos

    def skip_to(self, logical_offset: int) -> None:
        """Advance the cursor to a logical offset (resume path); raises on a
        stream shorter than the offset."""
        while self.base + len(self._buf) < logical_offset:
            self.base += len(self._buf)
            self._buf = b""
            try:
                self._buf = next(self._it)
            except StopIteration:
                raise ValueError(
                    f"stream ended before resume offset {logical_offset}"
                )
        self.pos = logical_offset - self.base


def stream_header(sr: StreamReader) -> BamHeader:
    """Parse the BAM header incrementally off a StreamReader."""
    if not sr.ensure(8):
        raise ValueError("truncated BAM header")
    mv = sr.view()
    if bytes(mv[sr.pos : sr.pos + 4]) != b"BAM\x01":
        raise ValueError("not a BAM file (missing BAM\\1 magic)")
    (l_text,) = struct.unpack_from("<i", mv, sr.pos + 4)
    if not sr.ensure(8 + l_text + 4):
        raise ValueError("truncated BAM header text")
    mv = sr.view()
    text = bytes(mv[sr.pos + 8 : sr.pos + 8 + l_text]).rstrip(b"\0").decode()
    (n_ref,) = struct.unpack_from("<i", mv, sr.pos + 8 + l_text)
    sr.pos += 8 + l_text + 4
    names, lengths = [], []
    for _ in range(n_ref):
        if not sr.ensure(4):
            raise ValueError("truncated BAM ref list")
        (l_name,) = struct.unpack_from("<i", sr.view(), sr.pos)
        if not sr.ensure(4 + l_name + 4):
            raise ValueError("truncated BAM ref name")
        mv = sr.view()
        names.append(bytes(mv[sr.pos + 4 : sr.pos + 4 + l_name - 1]).decode())
        (l_ref,) = struct.unpack_from("<i", mv, sr.pos + 4 + l_name)
        lengths.append(l_ref)
        sr.pos += 4 + l_name + 4
    return BamHeader(text, names, lengths)


def stream_reads(sr: StreamReader) -> Iterator[DecodedRead | None]:
    """Yield one (read-or-None-if-filtered) per record, incrementally."""
    while True:
        if not sr.ensure(4):
            return
        (block_size,) = struct.unpack_from("<i", sr.view(), sr.pos)
        if block_size < 32:
            raise ValueError("corrupt BAM record (block_size < 32)")
        if not sr.ensure(4 + block_size):
            raise ValueError("truncated BAM record")
        read, end, _ = _decode_read(sr.view(), sr.pos)
        sr.pos = end
        yield read


# ---- resume tokens ----------------------------------------------------------
# Binary format shared byte for byte with the native decoder (bamdecode.cpp
# make_token/restore_token), so a checkpoint written under either decoder
# resumes under the other:
#   magic 'IRT1' u32 | tell u64 | stats i64[5] | has_pending u8 | n_carry u8
#   | ParsedRead*   with ParsedRead = name_len u32 | name | ref_id i32 |
#   strand i32 | nb u32 | (s,e) i32 pairs | ng u32 | (s,e) i32 pairs
_TOKEN_MAGIC = 0x31545249


def _pack_read(r: DecodedRead) -> bytes:
    nm = r.name.encode()
    out = struct.pack("<I", len(nm)) + nm
    out += struct.pack("<iiI", r.ref_id, r.strand, len(r.blocks))
    for s, e in r.blocks:
        out += struct.pack("<ii", s, e)
    out += struct.pack("<I", len(r.gaps))
    for s, e in r.gaps:
        out += struct.pack("<ii", s, e)
    return out


def _unpack_read(mv, off: int) -> tuple[DecodedRead, int]:
    (nl,) = struct.unpack_from("<I", mv, off)
    off += 4
    name = bytes(mv[off : off + nl]).decode()
    off += nl
    ref_id, strand, nb = struct.unpack_from("<iiI", mv, off)
    off += 12
    blocks = [struct.unpack_from("<ii", mv, off + 8 * i) for i in range(nb)]
    off += 8 * nb
    (ng,) = struct.unpack_from("<I", mv, off)
    off += 4
    gaps = [struct.unpack_from("<ii", mv, off + 8 * i) for i in range(ng)]
    off += 8 * ng
    return DecodedRead(name, 0, ref_id, strand, blocks, gaps), off


def make_resume_token(
    offset: int, pending: DecodedRead | None, carry: tuple, stats: DecodeStats
) -> bytes:
    out = struct.pack(
        "<IQ5q",
        _TOKEN_MAGIC,
        offset,
        stats.reads_total,
        stats.reads_admitted,
        stats.fragments,
        stats.pairs,
        stats.singles,
    )
    out += struct.pack("<BB", 1 if pending is not None else 0, len(carry))
    if pending is not None:
        out += _pack_read(pending)
    for r in carry:
        out += _pack_read(r)
    return out


def parse_resume_token(blob: bytes):
    mv = memoryview(blob)
    magic, offset, rt, ra, fr, pr, sg = struct.unpack_from("<IQ5q", mv, 0)
    if magic != _TOKEN_MAGIC:
        raise ValueError("bad resume token (magic)")
    off = 4 + 8 + 40
    hp, nc = struct.unpack_from("<BB", mv, off)
    off += 2
    pending = None
    if hp:
        pending, off = _unpack_read(mv, off)
    carry = []
    for _ in range(nc):
        r, off = _unpack_read(mv, off)
        carry.append(r)
    st = DecodeStats(
        reads_total=rt, reads_admitted=ra, fragments=fr, pairs=pr, singles=sg
    )
    return offset, pending, tuple(carry), st


def decode_bam(
    fh: BinaryIO,
    chrom_index: dict,
    cap_frags: int = 1 << 15,
    resume_token: bytes | None = None,
    blocks_per_frag: int = BLOCKS_PER_FRAG,
    gaps_per_frag: int = GAPS_PER_FRAG,
) -> tuple[BamHeader, Iterator[PackedBatch], DecodeStats]:
    """Stream a BAM file into PackedBatches, incrementally: memory stays
    O(one BGZF block + one batch), and the first batch is emitted as soon as
    enough records have arrived — a live pipe (FastQ --stream mode) is
    counted while the aligner is still writing.

    chrom_index: {chrom_name: compiled_chrom_id} from the CompiledRef.
    Returns (header, batch iterator, stats object filled as iteration runs).
    Each batch flushed because it was full carries a `resume_token`
    reproducing the remaining stream when passed back via `resume_token=`
    (decoder-portable with the native decoder; resume skips BGZF blocks
    without parsing records).  The batches flushed at end of stream carry
    none.
    """
    sr = StreamReader(fh)
    header = stream_header(sr)
    lut = np.array(
        [chrom_index.get(nm, -1) for nm in header.ref_names], dtype=np.int32
    ).reshape(len(header.ref_names))
    header.chrom_lut = lut
    stats = DecodeStats()

    def gen() -> Iterator[PackedBatch]:
        builder = BatchBuilder(
            lut, cap_frags=cap_frags,
            blocks_per_frag=blocks_per_frag, gaps_per_frag=gaps_per_frag,
        )
        asm = FragmentAssembler()
        if resume_token is not None:
            offset, pending, carry, st0 = parse_resume_token(resume_token)
            sr.skip_to(offset)
            asm.pending = pending
            for k, v in dataclasses.asdict(st0).items():
                setattr(stats, k, v)
            if carry:
                builder.add_fragment(carry)
        for read in stream_reads(sr):
            stats.reads_total += 1
            if read is None:
                continue
            stats.reads_admitted += 1
            for frag in asm.push(read):
                stats.fragments += 1
                stats.pairs += len(frag) == 2
                stats.singles += len(frag) == 1
                done = builder.add_fragment(frag)
                if done is not None:
                    done.resume_token = make_resume_token(
                        sr.tell(), asm.pending, frag, stats
                    )
                    yield done
        for frag in asm.flush():
            stats.fragments += 1
            stats.singles += 1
            done = builder.add_fragment(frag)
            if done is not None:
                yield done
        final = builder.finish()
        if final.n_frags:
            yield final

    return header, gen(), stats
