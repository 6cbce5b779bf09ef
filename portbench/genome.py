"""The benchmark's intron maps: a synthetic annotation drawn from the
published statistics of the human gene structure, compiled by the frozen
map compiler (frozen/compile.py).

A configuration's ``map`` holds:

* ``chromosomes``: {name: length in bases}, the GRCh38 lengths;
* ``genes``: protein-coding genes over those chromosomes, shared out in
  proportion to length (largest remainder);
* ``exons_per_gene``, ``internal_exon_bp``, ``utr5_bp``, ``utr3_bp``,
  ``intron_bp``: each {"median", "mean"}, a log-normal fitted to the two
  (mu = ln median, sigma^2 = 2 ln(mean / median)); ``intron_bp`` also
  holds ``min`` and ``max``, where the draw is clipped;
* ``seed``: the map's own seed (the map is the configuration's, not the
  run's).

Each gene has two transcripts: all its exons, and all but one middle exon
(genes of three exons or more), so that the map holds nested introns as
real annotation does.  The first exon carries a 5' UTR, the last a 3' UTR.
Genes do not overlap; the space between them is shared out at random.
"""

from __future__ import annotations

import math

import numpy as np

from .frozen.compile import CompiledRef, Exon, compile_reference

#: where the first gene of a chromosome may start (room for the ROIs)
_LEAD = 100_000


def _lognormal(rng, stat: dict, n: int) -> np.ndarray:
    mu = math.log(stat["median"])
    sigma = math.sqrt(2.0 * math.log(stat["mean"] / stat["median"]))
    return rng.lognormal(mu, sigma, n)


def genes_per_chromosome(chromosomes: dict, genes: int) -> dict:
    """{name: genes}, in proportion to length, summing to ``genes``."""
    names = list(chromosomes)
    lens = np.array([chromosomes[c] for c in names], np.float64)
    share = genes * lens / lens.sum()
    out = np.floor(share).astype(np.int64)
    for k in np.argsort(-(share - out), kind="stable")[: genes - int(out.sum())]:
        out[k] += 1
    return dict(zip(names, out.tolist()))


def annotation(m: dict) -> list:
    """The exons of the map ``m`` (a configuration's ``map``)."""
    rng = np.random.default_rng(m["seed"])
    ib = m["intron_bp"]
    exons = []
    g = 0
    for chrom, n in genes_per_chromosome(m["chromosomes"], m["genes"]).items():
        if n == 0:
            continue
        n_ex = np.clip(np.rint(_lognormal(rng, m["exons_per_gene"], n)), 1, 363).astype(np.int64)
        total = int(n_ex.sum())
        ex_len = np.maximum(np.rint(_lognormal(rng, m["internal_exon_bp"], total)), 1).astype(np.int64)
        in_len = np.clip(np.rint(_lognormal(rng, ib, total)), ib["min"], ib["max"]).astype(np.int64)
        first = np.cumsum(n_ex) - n_ex
        ex_len[first] += np.rint(_lognormal(rng, m["utr5_bp"], n)).astype(np.int64)
        ex_len[first + n_ex - 1] += np.rint(_lognormal(rng, m["utr3_bp"], n)).astype(np.int64)
        in_len[first + n_ex - 1] = 0  # no intron after a gene's last exon
        extent = np.add.reduceat(ex_len + in_len, first)
        free = m["chromosomes"][chrom] - _LEAD - int(extent.sum())
        if free < 0:
            raise ValueError(f"{chrom}: {n} genes of {int(extent.sum())} bases do not fit")
        w = rng.exponential(1.0, n + 1)
        gaps = np.floor(free * w[:n] / w.sum()).astype(np.int64)
        starts = _LEAD + np.cumsum(gaps) + np.cumsum(extent) - extent
        strands = rng.integers(0, 2, n)
        skips = rng.integers(0, 1 << 30, n)
        for k in range(n):
            lo, cnt = int(first[k]), int(n_ex[k])
            el, il = ex_len[lo:lo + cnt], in_len[lo:lo + cnt]
            s = int(starts[k]) + np.concatenate([[0], np.cumsum(el + il)[:-1]])
            e = s + el
            gid = f"G{g:05d}"
            strand = "+" if strands[k] else "-"
            skip = 1 + int(skips[k]) % (cnt - 2) if cnt >= 3 else -1
            for j in range(cnt):
                exons.append(Exon(chrom, int(s[j]), int(e[j]), strand, gid, gid, f"{gid}.t1"))
            if skip > 0:
                for j in range(cnt):
                    if j != skip:
                        exons.append(Exon(chrom, int(s[j]), int(e[j]), strand, gid, gid, f"{gid}.t2"))
            g += 1
    return exons


def make_map(m: dict) -> CompiledRef:
    """The compiled map of ``m``, with an rRNA-like and a mitochondria-like
    region of interest at the head of its first chromosome."""
    chrom = next(iter(m["chromosomes"]))
    rois = [(chrom, 0, 50_000, "rRNA-like", "+"), (chrom, 50_000, 60_000, "Mt-like", ".")]
    return compile_reference(annotation(m), rois=rois)
