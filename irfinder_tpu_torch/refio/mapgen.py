"""Mappability exclusion-zone generation, the port's copy of
irfinder_tpu/refio/mapgen.py.

The reference's BuildRef tiled the genome with synthetic error-free reads,
remapped them with STAR, and marked regions whose synthetic reads failed to
map back uniquely as low-mappability exclusion zones.  Alignment stays
external here (same as the counting path): this module provides the two
host-side halves around the external aligner —

  generate:  FASTA -> tiled synthetic reads (FASTQ) on a (read_len, stride)
             grid, skipping N-containing tiles.
  collect:   the aligner's BAM of those reads -> exclusion BED.  A grid tile
             is CONFIRMED when a uniquely-mapped read (the decoder's own
             NH/MAPQ admission rule, semantics.py) starts exactly at its
             origin position on its origin chromosome; every unconfirmed
             tile's footprint is excluded.  Position-grid confirmation means
             no read-name bookkeeping is needed.

The resulting BED feeds `BuildRef --exclude` (refio/compile.py
extra_exclusions), exactly like a precomputed mappability file.
"""

from __future__ import annotations

import numpy as np

from .. import semantics as S


def read_fasta(path: str) -> dict:
    """Minimal FASTA reader -> {name: uppercase sequence bytes}."""
    seqs: dict = {}
    name = None
    chunks: list = []
    opener = open
    if path.endswith(".gz"):
        import gzip

        opener = gzip.open
    with opener(path, "rb") as fh:
        for ln in fh:
            ln = ln.strip()
            if ln.startswith(b">"):
                if name is not None:
                    seqs[name] = b"".join(chunks).upper()
                name = ln[1:].split()[0].decode()
                chunks = []
            elif ln:
                chunks.append(ln)
    if name is not None:
        seqs[name] = b"".join(chunks).upper()
    return seqs


def iter_tiles(
    seqs: dict,
    read_len: int = S.MAPGEN_READ_LEN,
    stride: int = S.MAPGEN_STRIDE,
):
    """Yield (chrom, pos, seq) for every grid tile without Ns."""
    for chrom, seq in seqs.items():
        for pos in range(0, max(0, len(seq) - read_len) + 1, stride):
            tile = seq[pos : pos + read_len]
            if len(tile) < read_len or b"N" in tile:
                continue
            yield chrom, pos, tile


def write_tile_fastq(
    seqs: dict,
    out,
    read_len: int = S.MAPGEN_READ_LEN,
    stride: int = S.MAPGEN_STRIDE,
) -> int:
    """Write the synthetic tile reads as FASTQ (error-free, Q40).  Returns
    the tile count.  `out` is a binary file object."""
    qual = b"I" * read_len
    n = 0
    for chrom, pos, tile in iter_tiles(seqs, read_len, stride):
        out.write(b"@mapgen|" + chrom.encode() + b"|" + str(pos).encode() + b"\n")
        out.write(tile + b"\n+\n" + qual + b"\n")
        n += 1
    return n


def collect_exclusions(
    bam,
    chrom_lengths: dict,
    read_len: int = S.MAPGEN_READ_LEN,
    stride: int = S.MAPGEN_STRIDE,
) -> list:
    """Aligned tile-read BAM -> merged exclusion intervals.

    bam: path or binary file object of the aligner output over the tile
    FASTQ.  chrom_lengths: {chrom: sequence length} of the tiled genome.
    Returns [(chrom, start, end)] covering every unconfirmed tile footprint.
    """
    from ..io.bampy import decode_bam

    chrom_names = list(chrom_lengths)
    chrom_index = {c: i for i, c in enumerate(chrom_names)}
    if isinstance(bam, str):
        bam = open(bam, "rb")
    hdr, batches, _stats = decode_bam(bam, chrom_index, cap_frags=1 << 15)

    # confirmation grid per chrom: one slot per stride-aligned tile start
    grids = {}
    for c, ln in chrom_lengths.items():
        n_tiles = max(0, ln - read_len) // stride + 1 if ln >= read_len else 0
        grids[c] = np.zeros(n_tiles, dtype=bool)

    for b in batches:
        nf = b.n_frags
        fc = b.frag_chrom[:nf]
        fs = b.frag_start[:nf]
        fe = b.frag_end[:nf]
        for c_idx, s, e in zip(fc, fs, fe):
            if c_idx < 0:
                continue
            c = chrom_names[int(c_idx)]
            g = grids[c]
            # a confirmed tile: admitted read spanning exactly [s, s+read_len)
            # starting on the grid
            if int(e) - int(s) == read_len and int(s) % stride == 0:
                t = int(s) // stride
                if 0 <= t < g.size:
                    g[t] = True

    out = []
    for c, ln in chrom_lengths.items():
        g = grids[c]
        # N-containing tiles were never generated; they are unmappable by
        # definition and stay excluded (conservative, like the reference).
        cur = None
        for t in range(g.size):
            if not g[t]:
                s, e = t * stride, t * stride + read_len
                if cur and s <= cur[1]:
                    cur = (cur[0], e)
                else:
                    if cur:
                        out.append((c, cur[0], cur[1]))
                    cur = (s, e)
        if cur:
            out.append((c, cur[0], cur[1]))
    return out


def write_bed(rows: list, out) -> None:
    for c, s, e in rows:
        out.write(f"{c}\t{s}\t{e}\tlow-mappability\n")
