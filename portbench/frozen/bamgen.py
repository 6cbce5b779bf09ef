"""Frozen copy of irfinder_tpu_torch/io/bamgen.py (commit fa27846): the
vectorized synthetic BAM generator's paired-end read mix, the benchmark's
traffic.  Two changes, the same bytes: ``realistic_stream`` is split into
``realistic_columns`` (the draw) and ``encode_records``, so that
records.py can encode the same draw with SEQ, QUAL and tags; the
long-read stream is left out.

Read-mix model of ``realistic_stream`` (fractions configurable):
  * pairs with adjacent mates in aligner output order (name-collated),
  * per-record CIGAR shape: 100M / 12S88M / 50M<g>N50M / 30M<g>N40M<g>N30M,
  * half of spliced gaps land EXACTLY on annotated introns of the provided
    CompiledRef; the other half are novel junctions from a bounded pool,
  * a MAPQ spectrum (255 / 50 / 3 — the 3s fall below semantics.MIN_MAPQ
    and are dropped, making their mates single-end fragments),
  * ~3% secondary records (FLAG 0x100, dropped at admission),
  * ~5% duplicate-flagged records (FLAG 0x400, counted).

``encode_records`` writes no SEQ, QUAL or tags; records.py does.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import bgzf

# CIGAR op codes
_M, _N, _S = 0, 3, 4

#: shape id -> number of cigar ops
_SHAPE_NOPS = (1, 2, 3, 5)
_NAME_LEN = 11  # "r%09d" + NUL


@dataclasses.dataclass
class MixStats:
    """Ground-truth composition of a generated stream (for tests)."""

    n_records: int
    n_pairs: int
    n_secondary: int
    n_low_mapq: int
    n_spliced: int  # records with >=1 N gap (admitted shapes only)


def _rec_dtype(n_ops: int) -> np.dtype:
    return np.dtype(
        [
            ("block_size", "<i4"),
            ("ref_id", "<i4"),
            ("pos", "<i4"),
            ("l_read_name", "u1"),
            ("mapq", "u1"),
            ("bin", "<u2"),
            ("n_cigar", "<u2"),
            ("flag", "<u2"),
            ("l_seq", "<i4"),
            ("next_ref", "<i4"),
            ("next_pos", "<i4"),
            ("tlen", "<i4"),
            ("name", f"S{_NAME_LEN}"),
            ("cigar", "<u4", (n_ops,)),
        ]
    )


def _names(pair_ids: np.ndarray) -> np.ndarray:
    """Vectorized b'r%09d\\0' name column as an S{_NAME_LEN} array."""
    n = pair_ids.size
    digs = np.empty((n, _NAME_LEN), np.uint8)
    digs[:, 0] = ord("r")
    v = pair_ids.astype(np.int64)
    for k in range(9):
        digs[:, 9 - k] = (v % 10) + ord("0")
        v //= 10
    digs[:, 10] = 0
    return np.ascontiguousarray(digs).view(f"S{_NAME_LEN}").reshape(n)


def encode_records(
    shape: np.ndarray,  # (n,) int8 in {0,1,2,3}
    ref_id: np.ndarray,
    pos: np.ndarray,
    flag: np.ndarray,
    mapq: np.ndarray,
    pair_id: np.ndarray,
    g1: np.ndarray,  # gap lengths (spliced shapes)
    g2: np.ndarray,
) -> bytes:
    """Encode n records (aligned in stream order) into one BAM byte payload."""
    n = shape.size
    widths = np.array([_rec_dtype(k).itemsize for k in _SHAPE_NOPS], np.int64)
    w = widths[shape]
    offsets = np.zeros(n, np.int64)
    np.cumsum(w[:-1], out=offsets[1:])
    total = int(offsets[-1] + w[-1]) if n else 0
    out = np.zeros(total, np.uint8)
    for cls in range(4):
        idx = np.flatnonzero(shape == cls)
        if idx.size == 0:
            continue
        dt = _rec_dtype(_SHAPE_NOPS[cls])
        arr = np.zeros(idx.size, dt)
        arr["block_size"] = dt.itemsize - 4
        arr["ref_id"] = ref_id[idx]
        arr["pos"] = pos[idx]
        arr["l_read_name"] = _NAME_LEN
        arr["mapq"] = mapq[idx]
        arr["n_cigar"] = _SHAPE_NOPS[cls]
        arr["flag"] = flag[idx]
        arr["next_ref"] = -1
        arr["next_pos"] = -1
        arr["name"] = _names(pair_id[idx])
        cig = arr["cigar"]
        if cls == 0:
            cig[:, 0] = (100 << 4) | _M
        elif cls == 1:
            cig[:, 0] = (12 << 4) | _S
            cig[:, 1] = (88 << 4) | _M
        elif cls == 2:
            cig[:, 0] = (50 << 4) | _M
            cig[:, 1] = (g1[idx].astype(np.uint32) << 4) | _N
            cig[:, 2] = (50 << 4) | _M
        else:
            cig[:, 0] = (30 << 4) | _M
            cig[:, 1] = (g1[idx].astype(np.uint32) << 4) | _N
            cig[:, 2] = (40 << 4) | _M
            cig[:, 3] = (g2[idx].astype(np.uint32) << 4) | _N
            cig[:, 4] = (30 << 4) | _M
        rows = arr.view(np.uint8).reshape(idx.size, dt.itemsize)
        # chunked scatter keeps the fancy-index array bounded (~64MB)
        step = max(1, (1 << 23) // dt.itemsize)
        for lo in range(0, idx.size, step):
            sl = slice(lo, lo + step)
            tgt = offsets[idx[sl], None] + np.arange(dt.itemsize)[None, :]
            out[tgt] = rows[sl]
    return out.tobytes()


def realistic_stream(ref, n_pairs: int, seed: int = 0, pid_offset: int = 0,
                     **mix_kw) -> tuple[bytes, MixStats]:
    """Build the record payload (post-header bytes) for a realistic mix
    against a CompiledRef's single-chromosome-family annotation.

    Returns (payload, ground-truth mix stats).  `ref_id` written is the
    compiled chrom id (the BAM header written around this must list
    ref.chroms in order).
    """
    cols, stats = realistic_columns(ref, n_pairs, seed=seed, pid_offset=pid_offset, **mix_kw)
    return encode_records(*cols), stats


def realistic_columns(
    ref,
    n_pairs: int,
    seed: int = 0,
    pid_offset: int = 0,
    spliced_frac: float = 0.30,
    softclip_frac: float = 0.10,
    twogap_frac: float = 0.05,
    low_mapq_frac: float = 0.05,
    secondary_frac: float = 0.03,
    dup_frac: float = 0.05,
    exact_junction_frac: float = 0.5,
    stranded: bool = False,
) -> tuple[tuple, MixStats]:
    """The records of a realistic mix as columns, in stream order:
    ((shape, ref_id, pos, flag, mapq, pair_id, gap1, gap2), mix stats),
    the arguments of encode_records."""
    rng = np.random.default_rng(seed)
    n_introns = ref.n_introns

    # one intron anchor per pair: positions cluster where counters hit
    ii = rng.integers(0, n_introns, n_pairs)
    chrom = ref.intron_chrom[ii].astype(np.int32)
    istart = ref.intron_start[ii].astype(np.int64)
    iend = ref.intron_end[ii].astype(np.int64)
    anchor = np.clip(istart + rng.integers(-300, 300, n_pairs), 0, None)

    # mate record tables (2 records per pair, interleaved at the end)
    def draw_shapes(n):
        u = rng.random(n)
        shp = np.zeros(n, np.int8)
        shp[u < softclip_frac] = 1
        lo = softclip_frac
        shp[(u >= lo) & (u < lo + spliced_frac - twogap_frac)] = 2
        lo += spliced_frac - twogap_frac
        shp[(u >= lo) & (u < lo + twogap_frac)] = 3
        return shp

    shp1 = draw_shapes(n_pairs)
    shp2 = draw_shapes(n_pairs)
    # spliced gaps: `exact_junction_frac` land exactly on the anchor intron
    # (SpliceExact hits); the rest are "novel" junctions drawn from a BOUNDED
    # per-intron variant pool (4 start offsets x 2 lengths) so the unique
    # junction-key count stays RNA-seq-realistic (~10-20 uniques per covered
    # intron, not one per read) — real samples re-observe the same noise
    # junctions, they don't mint a fresh one per spliced read.
    ilen = np.clip(iend - istart, 4, None)
    delta = np.array([-37, 3, 29, 67], np.int64)[rng.integers(0, 4, n_pairs)]
    nlen = np.array([211, 1531], np.int64)[rng.integers(0, 2, n_pairs)]
    exact = rng.random(n_pairs) < exact_junction_frac
    gap1 = np.where(exact, ilen, nlen)
    gstart = np.where(exact, istart, np.clip(istart + delta, 4, None))
    gap2 = np.array([97, 385], np.int64)[rng.integers(0, 2, n_pairs)]
    # spliced mate1 is anchored so its gap starts at gstart: shape 2 opens
    # with 50M, shape 3 with 30M
    pos1 = np.where(shp1 == 2, gstart - 50, np.where(shp1 == 3, gstart - 30, anchor))
    pos1 = np.clip(pos1, 0, None)
    pos2 = pos1 + rng.integers(150, 400, n_pairs)
    # spliced mate2 anchors on the same pair gap variant
    pos2 = np.where(shp2 == 2, gstart - 50, np.where(shp2 == 3, gstart - 30, pos2))
    pos2 = np.clip(pos2, 0, None)

    if stranded:
        # strand-specific library (config B): read1's alignment strand equals
        # the anchor gene's annotation strand — the directionality detector
        # must call the library stranded from the exact-junction counters
        rev1 = (ref.intron_strand[ii] == 1).astype(np.uint16)
    else:
        rev1 = rng.integers(0, 2, n_pairs).astype(np.uint16)
    dup = (rng.random(n_pairs) < dup_frac).astype(np.uint16) * 0x400
    f1 = 0x1 | 0x2 | 0x40 | np.where(rev1 == 1, 0x10, 0x20) | dup
    f2 = 0x1 | 0x2 | 0x80 | np.where(rev1 == 1, 0x20, 0x10) | dup
    mq = rng.choice(
        np.array([255, 50, 3], np.uint8),
        size=(2, n_pairs),
        p=[1 - 0.08 - low_mapq_frac, 0.08, low_mapq_frac],
    )

    # secondary extras (same name, dropped at admission)
    sec = rng.random(n_pairs) < secondary_frac

    # interleave: rec index 3*p + {0,1,2}; slot 2 only when sec[p]
    slots = 2 + sec.astype(np.int64)
    base = np.zeros(n_pairs, np.int64)
    np.cumsum(slots[:-1], out=base[1:])
    n_rec = int(base[-1] + slots[-1])

    shape = np.zeros(n_rec, np.int8)
    rid = np.zeros(n_rec, np.int32)
    pos = np.zeros(n_rec, np.int32)
    flag = np.zeros(n_rec, np.uint16)
    mapq = np.zeros(n_rec, np.uint8)
    pid = np.zeros(n_rec, np.int64)
    g1 = np.zeros(n_rec, np.int64)
    g2 = np.zeros(n_rec, np.int64)

    pids = np.arange(pid_offset, pid_offset + n_pairs, dtype=np.int64)
    for slot, (s_, p_, f_, m_) in enumerate(
        [(shp1, pos1, f1, mq[0]), (shp2, pos2, f2, mq[1])]
    ):
        at = base + slot
        shape[at] = s_
        rid[at] = chrom
        pos[at] = p_
        flag[at] = f_
        mapq[at] = m_
        pid[at] = pids
        g1[at] = gap1
        g2[at] = gap2
    at = (base + 2)[sec]
    shape[at] = 0
    rid[at] = chrom[sec]
    pos[at] = pos2[sec] + 7
    flag[at] = 0x100
    mapq[at] = 255
    pid[at] = pids[sec]

    admitted = mapq >= 5
    admitted &= (flag.astype(np.int64) & 0x100) == 0
    stats = MixStats(
        n_records=n_rec,
        n_pairs=n_pairs,
        n_secondary=int(sec.sum()),
        n_low_mapq=int((mapq < 5).sum()),
        n_spliced=int((admitted & (shape >= 2)).sum()),
    )
    return (shape, rid, pos, flag, mapq, pid, g1, g2), stats


def write_realistic_bam(
    path: str,
    ref,
    n_pairs: int,
    seed: int = 0,
    compress_level: int = 1,
    chunk_pairs: int = 1 << 20,
    **mix_kw,
) -> MixStats:
    """Generate and write a realistic-mix BAM against a CompiledRef.

    Generation is chunked (bounded memory) and BGZF-compressed at a fast
    level — the file is benchmark INPUT; its compression ratio only needs to
    be BAM-like, not archival."""
    header = _bam_header(ref)
    totals = MixStats(0, 0, 0, 0, 0)
    with open(path, "wb") as fh:
        first = True
        for lo in range(0, n_pairs, chunk_pairs):
            n = min(chunk_pairs, n_pairs - lo)
            payload, st = realistic_stream(
                ref, n, seed=seed + lo, pid_offset=lo, **mix_kw
            )
            if first:
                payload = header + payload
                first = False
            bgzf.write_payload(fh, payload, level=compress_level)
            totals.n_records += st.n_records
            totals.n_pairs += st.n_pairs
            totals.n_secondary += st.n_secondary
            totals.n_low_mapq += st.n_low_mapq
            totals.n_spliced += st.n_spliced
        if first:
            bgzf.write_payload(fh, header, level=compress_level)
        bgzf.close(fh)
    return totals


def _chrom_lengths(ref) -> list:
    """Per-chrom lengths covering every annotated coordinate (+ margin)."""
    ends = np.zeros(len(ref.chroms), np.int64)
    if ref.n_introns:
        np.maximum.at(ends, ref.intron_chrom.astype(np.int64), ref.intron_end)
    return [int(e) + 1_000_000 for e in ends]


def _bam_header(ref) -> bytes:
    import struct

    lengths = _chrom_lengths(ref)
    header = b"BAM\x01"
    text = b"@HD\tVN:1.6\tSO:unsorted\n"
    header += struct.pack("<i", len(text)) + text
    header += struct.pack("<i", len(ref.chroms))
    for nm, ln in zip(ref.chroms, lengths):
        b = nm.encode() + b"\0"
        header += struct.pack("<i", len(b)) + b + struct.pack("<i", int(ln))
    return header
