"""Frozen copy of irfinder_tpu_torch/io/bgzf.py (commit fa27846): the BGZF
block writer that the benchmark's BAMs are written with, and the block
reader that the plain reference inflates them with.

BGZF = concatenated gzip members, each with an extra subfield
(SI1=66,SI2=67,len=2) carrying BSIZE = total block size - 1.  A fixed 28-byte
empty block marks EOF.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Iterator

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HDR = struct.Struct("<4BI2BH")  # magic(4) mtime xfl os xlen


def write_block(out: BinaryIO, payload: bytes, level: int = 6) -> None:
    """Write one BGZF block (payload must be <= 65535 bytes pre-compression)."""
    assert len(payload) <= 0xFFFF
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    # total block = header(18) + cdata + crc32(4) + isize(4); BSIZE = total - 1
    bsize = 18 + len(cdata) + 8 - 1
    header = struct.pack(
        "<4BIBBHBBHH",
        0x1F,
        0x8B,
        8,
        4,  # magic, CM=deflate, FLG.FEXTRA
        0,  # mtime
        0,
        0xFF,  # XFL, OS
        6,  # XLEN
        66,
        67,  # SI1 SI2
        2,  # SLEN
        bsize,
    )
    out.write(header)
    out.write(cdata)
    out.write(struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload)))


def write_payload(
    out: BinaryIO, data: bytes, block_size: int = 60000, level: int = 6
) -> None:
    """Write arbitrary data as a sequence of BGZF blocks (no EOF marker)."""
    for i in range(0, len(data), block_size):
        write_block(out, data[i : i + block_size], level=level)
    if not data:
        write_block(out, b"")


def close(out: BinaryIO) -> None:
    out.write(BGZF_EOF)


def iter_blocks(fh: BinaryIO) -> Iterator[bytes]:
    """Yield the inflated payload of each BGZF block (including empty ones)."""
    while True:
        header = fh.read(12)
        if len(header) == 0:
            return
        if len(header) < 12:
            raise ValueError("truncated BGZF block header")
        magic1, magic2, cm, flg, _mtime, _xfl, _os, xlen = _HDR.unpack(header)
        if magic1 != 0x1F or magic2 != 0x8B or cm != 8 or not flg & 4:
            raise ValueError("not a BGZF block (bad gzip magic / FEXTRA)")
        extra = fh.read(xlen)
        if len(extra) < xlen:
            raise ValueError("truncated BGZF extra field")
        bsize = None
        off = 0
        while off + 4 <= xlen:
            si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from("<H", extra, off + 2)[0]
            if si1 == 66 and si2 == 67 and slen == 2:
                bsize = struct.unpack_from("<H", extra, off + 4)[0]
            off += 4 + slen
        if bsize is None:
            raise ValueError("BGZF BC subfield missing")
        cdata_len = bsize + 1 - 12 - xlen - 8
        cdata = fh.read(cdata_len)
        footer = fh.read(8)
        if len(cdata) < cdata_len or len(footer) < 8:
            raise ValueError("truncated BGZF block body")
        crc, isize = struct.unpack("<II", footer)
        payload = zlib.decompress(cdata, wbits=-15)
        if len(payload) != isize or (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise ValueError("BGZF block CRC/length mismatch (corrupt block)")
        yield payload


def read_all(fh: BinaryIO) -> bytes:
    return b"".join(iter_blocks(fh))
