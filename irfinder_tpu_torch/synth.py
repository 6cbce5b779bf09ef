"""Synthetic annotation / read-stream generators for the card checks and the
tests.

The reference shipped only a small manual example dataset (SURVEY.md §4); we
generate deterministic human-scale stand-ins: a chr21-like gene/intron map and
packed read batches with realistic hit statistics, so kernel throughput is
measured against honest table sizes (BASELINE.json:7: chr21, ~40k introns).
"""

from __future__ import annotations

import numpy as np

from .io.batch import BLOCKS_PER_FRAG, GAPS_PER_FRAG

from .refio.compile import CompiledRef, compile_reference
from .refio.gtf import Exon


def synth_exons(
    n_genes: int = 800,
    chrom: str = "chr21",
    chrom_len: int = 46_000_000,
    seed: int = 0,
    introns_per_gene: int = 8,
    n_chroms: int = 1,
):
    """A deterministic gene forest: `n_genes` genes tiled over the
    chromosome(s), each with introns_per_gene+1 exons and 2 transcripts (one
    skips an exon, creating nested unique introns like real annotation).
    n_chroms > 1 splits the genes round-robin over chrom.0..chrom.{k-1}
    (multi-chromosome maps for genome-shard tests)."""
    rng = np.random.default_rng(seed)
    exons = []
    per = chrom_len // (n_genes // max(1, n_chroms) + 2)
    span = chrom_len // (n_genes + 1) if n_chroms == 1 else per
    for g in range(n_genes):
        if n_chroms == 1:
            chrom_g, base = chrom, span // 2 + g * span
        else:
            chrom_g = f"{chrom}.{g % n_chroms}"
            base = span // 2 + (g // n_chroms) * span
        strand = "+" if rng.integers(0, 2) else "-"
        gid = f"G{g:05d}"
        pos = base
        coords = []
        for _ in range(introns_per_gene + 1):
            elen = int(rng.integers(80, 400))
            ilen = int(rng.integers(200, 4000))
            coords.append((pos, pos + elen))
            pos += elen + ilen
        for (s, e) in coords:
            exons.append(Exon(chrom_g, s, e, strand, gid, gid, f"{gid}.t1"))
        # transcript 2 skips one middle exon -> an exon-spanning unique intron
        skip = int(rng.integers(1, len(coords) - 1))
        for k, (s, e) in enumerate(coords):
            if k != skip:
                exons.append(Exon(chrom_g, s, e, strand, gid, gid, f"{gid}.t2"))
    return exons


def synth_ref(n_genes: int = 800, seed: int = 0, **kw) -> CompiledRef:
    ex = synth_exons(n_genes=n_genes, seed=seed, **kw)
    chrom = ex[0].chrom
    rois = [(chrom, 0, 50_000, "rRNA-like", "+"), (chrom, 50_000, 60_000, "Mt-like", ".")]
    return compile_reference(ex, rois=rois)


def synth_batch_arrays(
    ref: CompiledRef,
    n_frags: int = 1 << 15,
    seed: int = 1,
    paired_frac: float = 0.9,
    junction_frac: float = 0.25,
    read_len: int = 100,
) -> dict:
    """Packed batch columns with decode-realistic statistics: ~2 blocks per
    paired fragment, a junction_frac of fragments carrying one splice gap that
    lands EXACTLY on an annotated intron (exercising the hit path), the rest
    random genomic positions."""
    rng = np.random.default_rng(seed)
    n_introns = ref.n_introns
    cap_blocks = n_frags * BLOCKS_PER_FRAG
    cap_gaps = n_frags * GAPS_PER_FRAG

    frag_chrom = ref.intron_chrom[rng.integers(0, n_introns, n_frags)].astype(np.int32)
    # anchor positions near random introns so counters actually hit
    ii = rng.integers(0, n_introns, n_frags)
    anchor = ref.intron_start[ii].astype(np.int64) + rng.integers(-300, 300, n_frags)
    anchor = np.clip(anchor, 0, None)
    strand = rng.integers(0, 2, n_frags).astype(np.int32)
    is_pair = rng.random(n_frags) < paired_frac
    has_junc = rng.random(n_frags) < junction_frac

    blk_chrom = np.full(cap_blocks, -1, np.int32)
    blk_start = np.zeros(cap_blocks, np.int32)
    blk_end = np.zeros(cap_blocks, np.int32)
    blk_strand = np.zeros(cap_blocks, np.int32)
    gap_chrom = np.full(cap_gaps, -1, np.int32)
    gap_start = np.zeros(cap_gaps, np.int32)
    gap_end = np.zeros(cap_gaps, np.int32)
    gap_strand = np.zeros(cap_gaps, np.int32)

    nb = ng = 0
    # vectorized assembly: mate1 block always; junction fragments split mate1
    # into two blocks around the exact intron; mate2 block when paired
    for f in range(n_frags):
        c, a, st = frag_chrom[f], int(anchor[f]), strand[f]
        if has_junc[f]:
            k = int(ii[f])
            gs, ge = int(ref.intron_start[k]), int(ref.intron_end[k])
            blk_chrom[nb], blk_start[nb], blk_end[nb], blk_strand[nb] = c, gs - 50, gs, st
            blk_chrom[nb + 1], blk_start[nb + 1], blk_end[nb + 1], blk_strand[nb + 1] = (
                c, ge, ge + 50, st,
            )
            nb += 2
            gap_chrom[ng], gap_start[ng], gap_end[ng], gap_strand[ng] = c, gs, ge, st
            ng += 1
        else:
            blk_chrom[nb], blk_start[nb], blk_end[nb], blk_strand[nb] = (
                c, a, a + read_len, st,
            )
            nb += 1
        if is_pair[f]:
            m2 = a + int(rng.integers(150, 400))
            blk_chrom[nb], blk_start[nb], blk_end[nb], blk_strand[nb] = (
                c, m2, m2 + read_len, st,
            )
            nb += 1

    frag_start = anchor.astype(np.int32)
    frag_end = (anchor + 500).astype(np.int32)
    # per-fragment block count, matching the assembly loop above: junction
    # fragments carry 2 mate1 blocks, others 1, plus 1 mate2 block when paired
    # (route_flat_batch routes frag_nblk since wire v3 — a synth batch must
    # carry every routed frag column)
    frag_nblk = (np.where(has_junc, 2, 1) + is_pair).astype(np.int32)
    return {
        "blk_chrom": blk_chrom,
        "blk_start": blk_start,
        "blk_end": blk_end,
        "blk_strand": blk_strand,
        "gap_chrom": gap_chrom,
        "gap_start": gap_start,
        "gap_end": gap_end,
        "gap_strand": gap_strand,
        "frag_chrom": frag_chrom,
        "frag_refid": frag_chrom.copy(),
        "frag_start": frag_start,
        "frag_end": frag_end,
        "frag_strand": strand,
        "frag_nblk": frag_nblk,
    }, int(n_frags + is_pair.sum())  # (arrays, n_reads)
