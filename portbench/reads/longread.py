"""Long-read BAMs: Oxford Nanopore full-length cDNA reads as minimap2
``-ax splice`` writes them, each drawn from the map's own transcripts
(genome.annotation).  A traffic file names this module with
``"reads": "longread"`` and holds every share and rate used below.

Each read:

* comes from one transcript: a gene by a skewed expression draw (a
  log-normal weight per gene from the traffic's ``expression`` seed, the
  same in every run: one tissue's profile, sampled by the run's seed),
  then the gene's ``.t1``, or at ``second_transcript_share`` its ``.t2``
  (the one that skips a middle exon) where the gene has one;
* is a 3'-anchored piece of it: whole at ``full_length_share``, else cut
  at the 5' end to a uniform share (``truncated_min_share`` .. 1, at least
  ``min_read_bp``) of its length; a terminal block shorter than
  ``min_terminal_block_bp`` is left unaligned;
* aligns one block per exon, the introns as N; at
  ``retained_intron_share`` the read keeps one of its introns no longer
  than ``retained_intron_max_bp`` aligned; every other junction, at
  ``novel_junction_share``, moves its left or right end by 1 ..
  ``novel_shift_max_bp`` bases (so novel sites come from a small pool
  beside each annotated one), leaving each side at least half its bases;
* carries I and D operations of ``indel_bp`` bases, one every
  ``indel_spacing_bp`` aligned bases (uniform), D at ``deletion_share``,
  each inside its block, and soft clips at both ends (``soft_clip_5p_bp``:
  the adapter; ``soft_clip_3p_bp``: poly-A and adapter);
* has a random strand (the library is unstranded) and a MAPQ from
  ``mapq``; at ``supplementary_share`` and ``secondary_share`` it also has
  one supplementary record (0x800, hard-clipped) and one secondary record
  (0x100, MAPQ 0, no SEQ), each another alignment under its name, after
  its primary, as minimap2 writes them;
* is named by a 36-character UUID, holds its query in SEQ (4-bit codes) and
  QUAL drawn from ``qual`` (Phred values and their shares), and carries
  minimap2's tags NM, ms, AS, nn, ts, tp, cm, s1, s2, de and rl.

Blocks are BGZF at level 1 of htslib's 0xff00 bytes, so records cross
block boundaries.  Chunks of reads are made on threads, each from its own
seed, so the bytes do not depend on thread order.  Imports nothing of the
program.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import genome, records
from ..frozen import bamgen, bgzf

#: the warm-up sample: the cell's traffic with these keys replaced (more
#: reads than one batch of the long-read geometry holds)
WARMUP = {"reads_per_sample": 40_000}
THREADS = min(8, os.cpu_count() or 1)
CHUNK_READS = 1 << 14
#: htslib's BGZF_BLOCK_SIZE: the payload of each block
_BLOCK = 0xFF00
_M, _I, _D, _N, _S, _H = 0, 1, 2, 3, 4, 5
PRIMARY, SUPPLEMENTARY, SECONDARY = 0, 1, 2
_NAME_LEN = 37  # a UUID and its NUL
_HEAD = 36 + _NAME_LEN
_FIXED_DT = records._FIXED_DT
#: minimap2's tags in its order: (tag, BAM type, the value's dtype)
_TAGS = (("NM", "S", "<u2"), ("ms", "i", "<i4"), ("AS", "i", "<i4"), ("nn", "C", "u1"),
         ("ts", "A", "S1"), ("tp", "A", "S1"), ("cm", "S", "<u2"), ("s1", "i", "<i4"),
         ("s2", "i", "<i4"), ("de", "f", "<f4"), ("rl", "S", "<u2"))
_TAGS_DT = np.dtype([f for tag, _, dt in _TAGS for f in ((tag + "_", "S3"), (tag, dt))])
_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)
_UUID_COLS = np.r_[0:8, 9:13, 14:18, 19:23, 24:36]


@dataclasses.dataclass
class Transcripts:
    """The map's transcripts, each one's exons in ascending order."""

    chrom: np.ndarray  # (T,) index into the map's chromosomes
    reverse: np.ndarray  # (T,) on the '-' strand
    first: np.ndarray  # (T,) its first exon
    length: np.ndarray  # (T,) exonic bases
    ex_start: np.ndarray  # (E,)
    ex_end: np.ndarray  # (E,)
    ex_base: np.ndarray  # (E,) exonic bases of every exon before it, over all transcripts
    t1: np.ndarray  # (G,) each gene's first transcript
    t2: np.ndarray  # (G,) its second, or -1


def transcripts(m: dict, chroms: list) -> Transcripts:
    """The transcripts of the map ``m`` (a configuration's ``map``), whose
    compiled chromosomes are ``chroms``."""
    by_tx: dict = {}
    for e in genome.annotation(m):
        by_tx.setdefault(e.transcript_id, []).append(e)
    chrom_of = {c: i for i, c in enumerate(chroms)}
    genes: dict = {}
    chrom, rev, n_ex, starts, ends = [], [], [], [], []
    for t, (tid, exons) in enumerate(by_tx.items()):
        exons = sorted(exons, key=lambda e: e.start)
        genes.setdefault(exons[0].gene_id, []).append(t)
        chrom.append(chrom_of[exons[0].chrom])
        rev.append(exons[0].strand == "-")
        n_ex.append(len(exons))
        starts += [e.start for e in exons]
        ends += [e.end for e in exons]
    ex_start, ex_end, n_ex = (np.array(v, np.int64) for v in (starts, ends, n_ex))
    ex_len = ex_end - ex_start
    first = np.cumsum(n_ex) - n_ex
    return Transcripts(
        chrom=np.array(chrom, np.int64), reverse=np.array(rev, bool), first=first,
        length=np.add.reduceat(ex_len, first), ex_start=ex_start, ex_end=ex_end,
        ex_base=np.cumsum(ex_len) - ex_len,
        t1=np.array([ts[0] for ts in genes.values()], np.int64),
        t2=np.array([ts[1] if len(ts) > 1 else -1 for ts in genes.values()], np.int64),
    )


def gene_weights(traffic: dict, n_genes: int) -> np.ndarray:
    """Each gene's share of the reads: log-normal weights from the
    traffic's expression seed."""
    ex = traffic["expression"]
    w = np.random.default_rng(ex["seed"]).lognormal(0.0, ex["lognormal_sigma"], n_genes)
    return w / w.sum()


@dataclasses.dataclass
class Alignments:
    """The alignments of a chunk of reads, in file order, and what was drawn
    for each."""

    role: np.ndarray  # PRIMARY, SUPPLEMENTARY or SECONDARY
    read: np.ndarray  # the read it belongs to, within the chunk
    transcript: np.ndarray
    chrom: np.ndarray
    start: np.ndarray  # first aligned base
    end: np.ndarray  # past the last
    reverse: np.ndarray  # the alignment's strand (FLAG 0x10)
    antisense: np.ndarray  # the alignment's strand is not its transcript's
    mapq: np.ndarray
    #: the N operations, by alignment then position
    gap_aln: np.ndarray
    gap_start: np.ndarray
    gap_end: np.ndarray
    gap_novel: np.ndarray  # one end moved off the annotated intron
    #: the intron kept aligned, or -1
    retained_start: np.ndarray
    retained_end: np.ndarray


def _segments(counts: np.ndarray) -> tuple:
    """(segment, index within it) of every element of segments of
    ``counts`` elements laid end to end."""
    seg = np.repeat(np.arange(counts.size), counts)
    return seg, np.arange(seg.size) - np.repeat(np.cumsum(counts) - counts, counts)


def _uniform(rng, bounds, n: int) -> np.ndarray:
    lo, hi = bounds
    return rng.integers(lo, hi + 1, n)


def draw(tx: Transcripts, p_gene: np.ndarray, traffic: dict, n: int, rng) -> Alignments:
    """The alignments of ``n`` reads."""
    sup = np.flatnonzero(rng.random(n) < traffic["supplementary_share"])
    sec = np.flatnonzero(rng.random(n) < traffic["secondary_share"])
    read = np.concatenate([np.arange(n), sup, sec])
    role = np.repeat([PRIMARY, SUPPLEMENTARY, SECONDARY], [n, sup.size, sec.size])
    order = np.lexsort((role, read))
    read, role = read[order], role[order]
    m = read.size

    # which transcript, and which 3'-anchored piece of it
    g = rng.choice(p_gene.size, m, p=p_gene)
    alt = (tx.t2[g] >= 0) & (rng.random(m) < traffic["second_transcript_share"])
    t = np.where(alt, tx.t2[g], tx.t1[g])
    length = tx.length[t]
    cut = np.maximum(np.rint(rng.uniform(traffic["truncated_min_share"], 1.0, m) * length),
                     np.minimum(length, traffic["min_read_bp"])).astype(np.int64)
    keep = np.where(rng.random(m) < traffic["full_length_share"], length, cut)
    # [a, b): exonic coordinates over all transcripts, in genomic order
    base = tx.ex_base[tx.first[t]]
    a = base + np.where(tx.reverse[t], 0, length - keep)
    b = a + keep
    cum, last_ex = tx.ex_base, tx.ex_base.size - 1
    j0 = np.searchsorted(cum, a, "right") - 1
    j1 = np.searchsorted(cum, b - 1, "right") - 1
    short = traffic["min_terminal_block_bp"]
    drop = (j0 < j1) & (tx.ex_end[j0] - tx.ex_start[j0] - (a - cum[j0]) < short)
    a = np.where(drop, cum[np.minimum(j0 + 1, last_ex)], a)
    j0 = j0 + drop
    drop = (j0 < j1) & (b - cum[j1] < short)
    b = np.where(drop, cum[j1], b)
    j1 = j1 - drop

    # one block per exon
    nb = j1 - j0 + 1
    blk_aln, k = _segments(nb)
    e = j0[blk_aln] + k
    bs, be = tx.ex_start[e].copy(), tx.ex_end[e].copy()
    fb = np.cumsum(nb) - nb
    lb = fb + nb - 1
    bs[fb] = tx.ex_start[j0] + a - cum[j0]
    be[lb] = tx.ex_start[j1] + b - cum[j1]
    left = np.ones(bs.size, bool)
    left[lb] = False
    gi = np.flatnonzero(left)  # the block before each junction
    gap_aln, gs, ge = blk_aln[gi], be[gi], bs[gi + 1]
    gl = ge - gs

    # a retained intron: one eligible junction of a chosen read, at random
    cand = np.flatnonzero((gl <= traffic["retained_intron_max_bp"])
                          & (rng.random(m) < traffic["retained_intron_share"])[gap_aln])
    cand = cand[np.lexsort((rng.random(cand.size), gap_aln[cand]))]
    pick = cand[np.r_[gap_aln[cand][1:] != gap_aln[cand][:-1], True]] if cand.size else cand
    retained = np.zeros(gs.size, bool)
    retained[pick] = True
    ret_start = np.full(m, -1, np.int64)
    ret_end = np.full(m, -1, np.int64)
    ret_start[gap_aln[pick]], ret_end[gap_aln[pick]] = gs[pick], ge[pick]

    # novel sites: one end of a junction moved, each side keeping half its bases
    novel = ~retained & (rng.random(gs.size) < traffic["novel_junction_share"])
    right_end = rng.random(gs.size) < 0.5
    shift = _uniform(rng, (1, traffic["novel_shift_max_bp"]), gs.size)
    shift *= rng.choice([-1, 1], gs.size)
    widens = np.where(right_end, shift > 0, shift < 0)  # the gap grows into a block
    blk_len = be - bs
    room = np.where(widens, np.where(right_end, blk_len[gi + 1], blk_len[gi]), gl)
    novel &= 2 * np.abs(shift) < room
    gs = gs + np.where(novel & ~right_end, shift, 0)
    ge = ge + np.where(novel & right_end, shift, 0)

    mq = traffic["mapq"]
    mapq = rng.choice(np.array(mq["values"], np.int64), m, p=mq["shares"])
    reverse = rng.random(m) < 0.5
    kept = ~retained
    return Alignments(
        role=role, read=read, transcript=t, chrom=tx.chrom[t], start=bs[fb], end=be[lb],
        reverse=reverse, antisense=reverse != tx.reverse[t],
        mapq=np.where(role == SECONDARY, 0, mapq),
        gap_aln=gap_aln[kept], gap_start=gs[kept], gap_end=ge[kept], gap_novel=novel[kept],
        retained_start=ret_start, retained_end=ret_end,
    )


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """SAM's reg2bin of [beg, end)."""
    end = end - 1
    conds, vals = [], []
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        conds.append(beg >> shift == end >> shift)
        vals.append(off + (beg >> shift))
    return np.select(conds, vals, 0)


def _pair_lut(lut: np.ndarray) -> np.ndarray:
    """65,536 entries: two random bytes, read as one little-endian uint16,
    mapped through the 256-entry ``lut`` each."""
    v = np.arange(1 << 16)
    return (lut[v & 0xFF].astype(np.uint16) | (lut[v >> 8].astype(np.uint16) << 8)).astype("<u2")


def _qual_lut(spec: dict) -> np.ndarray:
    """A pair LUT of Phred values ``spec["values"]`` at ``spec["shares"]``."""
    edges = np.rint(np.cumsum(spec["shares"]) * 256).astype(np.int64)
    lut = np.array(spec["values"], np.uint8)[
        np.minimum(np.searchsorted(edges, np.arange(256), side="right"), len(edges) - 1)]
    return _pair_lut(lut)


_SEQ_PAIRS = _pair_lut(records._SEQ_LUT)


def _draw_bytes(rng, lut: np.ndarray, n: int) -> np.ndarray:
    """``n`` bytes: random pairs through a pair LUT."""
    return lut[np.frombuffer(rng.bytes(n + (n & 1)), "<u2")].view(np.uint8)[:n]


def encode(al: Alignments, traffic: dict, rng) -> bytes:
    """The records of ``al`` as BAM bytes."""
    m = al.role.size
    # blocks: [start, gap ends...] to [gap starts..., end]
    nb = np.bincount(al.gap_aln, minlength=m) + 1
    blk_aln, k = _segments(nb)
    first, last = k == 0, k == nb[blk_aln] - 1
    bs = np.empty(blk_aln.size, np.int64)
    be = np.empty(blk_aln.size, np.int64)
    bs[first], bs[~first] = al.start, al.gap_end
    be[last], be[~last] = al.end, al.gap_start
    blen = be - bs

    # indels: one every indel_spacing_bp aligned bases, each inside its block
    lo, hi = traffic["indel_spacing_bp"]
    top = traffic["indel_bp"][1]
    room = blen // lo + 1
    ev_blk, _ = _segments(room)
    step = _uniform(rng, (lo, hi), ev_blk.size)
    cs = np.cumsum(step)
    first_ev = np.cumsum(room) - room
    pos = cs - np.repeat(cs[first_ev] - step[first_ev], room)
    ok = pos + top + 1 <= blen[ev_blk]
    ev_blk, pos = ev_blk[ok], pos[ok]
    is_del = rng.random(pos.size) < traffic["deletion_share"]
    ev_len = _uniform(rng, traffic["indel_bp"], pos.size)
    ev_ref = np.where(is_del, ev_len, 0)
    k_blk = np.bincount(ev_blk, minlength=blk_aln.size)
    _, j = _segments(k_blk)
    prev = np.r_[0, (pos + ev_ref)[:-1]]
    prev[j == 0] = 0
    tail = blen.copy()
    has = k_blk > 0
    tail[has] -= (pos + ev_ref)[np.cumsum(k_blk)[has] - 1]

    # CIGAR, in order: clip, per block (M, I|D)* M and N but after the last, clip
    nops_b = 2 * k_blk + 1 + ~last
    aln_blk0 = np.cumsum(nb) - nb
    aln_ops = np.add.reduceat(nops_b, aln_blk0) + 2
    aln_op0 = np.cumsum(aln_ops) - aln_ops
    blk_op0 = np.cumsum(nops_b) - nops_b + 2 * blk_aln + 1
    n_ops = int(aln_ops.sum())
    if aln_ops.max(initial=0) > 0xFFFF:
        raise ValueError("an alignment of more than 65535 CIGAR operations")
    op = np.empty(n_ops, np.int64)
    ln = np.empty(n_ops, np.int64)
    at = blk_op0[ev_blk] + 2 * j
    op[at], ln[at] = _M, pos - prev
    op[at + 1], ln[at + 1] = np.where(is_del, _D, _I), ev_len
    at = blk_op0 + 2 * k_blk
    op[at], ln[at] = _M, tail
    op[at[~last] + 1], ln[at[~last] + 1] = _N, (bs[1:] - be[:-1])[~last[:-1]]
    clip_5 = _uniform(rng, traffic["soft_clip_5p_bp"], m)
    clip_3 = _uniform(rng, traffic["soft_clip_3p_bp"], m)
    clip_op = np.where(al.role == PRIMARY, _S, _H)
    op[aln_op0], ln[aln_op0] = clip_op, np.where(al.reverse, clip_3, clip_5)
    aln_op1 = aln_op0 + aln_ops - 1
    op[aln_op1], ln[aln_op1] = clip_op, np.where(al.reverse, clip_5, clip_3)

    match, ins, dels = (np.add.reduceat(np.where(op == c, ln, 0), aln_op0) for c in (_M, _I, _D))
    n_ev = np.add.reduceat(k_blk, aln_blk0)
    l_seq = np.where(al.role == SECONDARY, 0,
                     match + ins + np.where(al.role == PRIMARY, clip_5 + clip_3, 0))

    # minimap2's tags (splice preset: match 1, mismatch 2, gap 2 + 1 a base)
    tr = traffic["tags"]
    mism = rng.binomial(match, traffic["mismatch_rate"])
    score = np.maximum(match - 3 * mism - 2 * n_ev - ins - dels, 0)
    cm = rng.binomial(match, tr["minimizers_per_aligned_bp"])
    s1 = tr["chain_score_per_minimizer"] * cm
    sec = al.role == SECONDARY
    n_reads = int(al.read.max(initial=-1)) + 1
    s2 = np.zeros(n_reads, np.int64)
    s2[al.read[sec]] = s1[sec]
    tags = np.zeros(m, _TAGS_DT)
    for tag, code, _ in _TAGS:
        tags[tag + "_"] = (tag + code).encode()
    tags["NM"] = np.minimum(mism + ins + dels, 0xFFFF)
    tags["ms"] = score
    tags["AS"] = score
    tags["ts"] = np.where(al.antisense, b"-", b"+")
    tags["tp"] = np.where(sec, b"S", b"P")
    tags["cm"] = np.minimum(cm, 0xFFFF)
    tags["s1"] = s1
    tags["s2"] = np.where(al.role == PRIMARY, s2[al.read], 0)
    tags["de"] = (mism + n_ev) / np.maximum(match + n_ev, 1)
    tags["rl"] = np.where(rng.random(m) < tr["repeat_share"], _uniform(rng, tr["repeat_bp"], m), 0)

    # the records: fixed fields and name, CIGAR, SEQ, QUAL, tags
    widths = np.stack([np.full(m, _HEAD), 4 * aln_ops, (l_seq + 1) // 2, l_seq,
                       np.full(m, _TAGS_DT.itemsize)], axis=1)
    fixed = np.zeros(m, _FIXED_DT)
    fixed["block_size"] = widths.sum(axis=1) - 4
    fixed["ref_id"] = al.chrom
    fixed["pos"] = al.start
    fixed["l_read_name"] = _NAME_LEN
    fixed["mapq"] = al.mapq
    fixed["bin"] = _reg2bin(al.start, al.end)
    fixed["n_cigar"] = aln_ops
    fixed["flag"] = (0x10 * al.reverse | np.where(al.role == SECONDARY, 0x100, 0)
                     | np.where(al.role == SUPPLEMENTARY, 0x800, 0))
    fixed["l_seq"] = l_seq
    fixed["next_ref"] = -1
    fixed["next_pos"] = -1
    head = np.zeros((m, _HEAD), np.uint8)
    head[:, :36] = fixed.view(np.uint8).reshape(m, 36)
    nib = rng.integers(0, 16, (n_reads, 32), dtype=np.uint8)
    nib[:, 12] = 4  # a version 4 UUID
    nib[:, 16] = 8 | (nib[:, 16] & 3)
    uuid = np.full((n_reads, _NAME_LEN - 1), ord("-"), np.uint8)
    uuid[:, _UUID_COLS] = _HEX[nib]
    head[:, 36:36 + _NAME_LEN - 1] = uuid[al.read]

    seq = _draw_bytes(rng, _SEQ_PAIRS, int(widths[:, 2].sum()))
    odd = l_seq % 2 == 1
    seq[(np.cumsum(widths[:, 2]) - 1)[odd]] &= 0xF0  # the last byte's unused half
    qual = _draw_bytes(rng, _qual_lut(traffic["qual"]), int(l_seq.sum()))
    cigar = ((ln.astype(np.uint32) << 4) | op.astype(np.uint32)).astype("<u4")
    parts = [memoryview(np.ascontiguousarray(a).view(np.uint8).reshape(-1))
             for a in (head, cigar, seq, qual, tags)]
    offs = [np.r_[0, np.cumsum(widths[:, p])].tolist() for p in range(5)]
    return b"".join([v[o[i]:o[i + 1]] for i in range(m) for v, o in zip(parts, offs)])


def _chunk(tx: Transcripts, p_gene, traffic: dict, n: int, seed: int, lo: int) -> tuple:
    """(BGZF blocks, records) of reads ``lo`` .. ``lo + n`` of the sample of
    ``seed``."""
    rng = np.random.default_rng([seed, lo])
    al = draw(tx, p_gene, traffic, n, rng)
    data = encode(al, traffic, rng)
    blocks = b"".join(records._block(data[i:i + _BLOCK]) for i in range(0, len(data), _BLOCK))
    return blocks, al.role.size


def write_bam(path: str, ref, config: dict, traffic: dict, seed: int,
              chunk_reads: int = CHUNK_READS) -> int:
    """A BAM of the traffic's ``reads_per_sample`` reads from ``seed`` at
    ``path``, against the configuration's map (``ref`` is its compiled
    form); returns its number of records."""
    tx = transcripts(config["map"], list(ref.chroms))
    p_gene = gene_weights(traffic, tx.t1.size)
    n_reads = int(traffic["reads_per_sample"])
    n_records = 0
    with open(path, "wb") as fh, ThreadPoolExecutor(THREADS) as ex:
        fh.write(records._block(bamgen._bam_header(ref)))
        for blocks, n in ex.map(
                lambda lo: _chunk(tx, p_gene, traffic, min(chunk_reads, n_reads - lo), seed, lo),
                range(0, n_reads, chunk_reads)):
            fh.write(blocks)
            n_records += n
        fh.write(bgzf.BGZF_EOF)
    return n_records
