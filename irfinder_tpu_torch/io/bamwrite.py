"""BAM record writer for tests and stand-in aligner output, the port's copy
of irfinder_tpu/io/bamwrite.py.

Writes spec-compliant BAM from hand-built alignments with known expected
counts: BGZF container, BAM\\1 header, minimal alignment records.  Mapability's
checks write their stand-in aligner BAM with it.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterable, Sequence

from . import bgzf

CIGAR_OPS = "MIDNSHP=X"


def encode_cigar(cigar: Sequence[tuple[int, str]]) -> bytes:
    out = b""
    for length, op in cigar:
        out += struct.pack("<I", (length << 4) | CIGAR_OPS.index(op))
    return out


def encode_record(
    name: str,
    flag: int,
    ref_id: int,
    pos: int,
    mapq: int,
    cigar: Sequence[tuple[int, str]],
    next_ref_id: int = -1,
    next_pos: int = -1,
    tlen: int = 0,
    seq_len: int = 0,
) -> bytes:
    """Encode one BAM alignment record (no SEQ/QUAL bases, no tags)."""
    rname = name.encode() + b"\0"
    cig = encode_cigar(cigar)
    body = struct.pack(
        "<iiBBHHHiiii",
        ref_id,
        pos,
        len(rname),
        mapq,
        0,  # bin (unused by us)
        len(cigar),
        flag,
        seq_len,
        next_ref_id,
        next_pos,
        tlen,
    )
    body += rname + cig
    body += b"\0" * ((seq_len + 1) // 2) + b"\xff" * seq_len  # seq nibbles + qual
    return struct.pack("<i", len(body)) + body


def write_bam(
    out: BinaryIO,
    ref_names: Sequence[str],
    ref_lengths: Sequence[int],
    records: Iterable[bytes],
    text: str = "@HD\tVN:1.6\tSO:unsorted\n",
) -> None:
    header = b"BAM\x01"
    t = text.encode()
    header += struct.pack("<i", len(t)) + t
    header += struct.pack("<i", len(ref_names))
    for nm, ln in zip(ref_names, ref_lengths):
        b = nm.encode() + b"\0"
        header += struct.pack("<i", len(b)) + b + struct.pack("<i", ln)
    payload = header + b"".join(records)
    bgzf.write_payload(out, payload)
    bgzf.close(out)


class SimRead:
    """Convenience builder: aligned read from (ref_id, pos, cigar string)."""

    @staticmethod
    def parse_cigar(s: str) -> list[tuple[int, str]]:
        out, num = [], ""
        for ch in s:
            if ch.isdigit():
                num += ch
            else:
                out.append((int(num), ch))
                num = ""
        return out


def make_pair(
    name: str,
    ref_id: int,
    pos1: int,
    cigar1: str,
    pos2: int,
    cigar2: str,
    reverse1: bool = False,
    mapq: int = 255,
) -> list[bytes]:
    """A proper pair: read1 at pos1, read2 at pos2, opposite strands."""
    c1 = SimRead.parse_cigar(cigar1)
    c2 = SimRead.parse_cigar(cigar2)
    f1 = 0x1 | 0x2 | 0x40 | (0x10 if reverse1 else 0x20)
    f2 = 0x1 | 0x2 | 0x80 | (0x20 if reverse1 else 0x10)
    return [
        encode_record(name, f1, ref_id, pos1, mapq, c1, ref_id, pos2),
        encode_record(name, f2, ref_id, pos2, mapq, c2, ref_id, pos1),
    ]


def make_single(
    name: str, ref_id: int, pos: int, cigar: str, reverse: bool = False, mapq: int = 255, flag_extra: int = 0
) -> bytes:
    flag = (0x10 if reverse else 0) | flag_extra
    return encode_record(name, flag, ref_id, pos, mapq, SimRead.parse_cigar(cigar))
