"""Minimal, strict GTF exon parser feeding the reference compiler
(refio/compile.py), the port's copy of irfinder_tpu/refio/gtf.py.

Only what intron derivation needs is parsed: ``exon`` features with
gene/transcript identity and strand, from plain or gzipped files.
Coordinates are converted from GTF 1-based-inclusive to 0-based half-open on
ingest (see semantics.py coordinate conventions).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
from typing import Iterable


@dataclasses.dataclass
class Exon:
    chrom: str
    start: int  # 0-based
    end: int  # exclusive
    strand: str  # '+' or '-'
    gene_id: str
    gene_name: str
    transcript_id: str


def _parse_attrs(field: str) -> dict:
    """Parse the GTF attribute column: key "value"; key "value";"""
    attrs = {}
    for part in field.rstrip(";").split(";"):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition(" ")
        attrs[key] = val.strip().strip('"')
    return attrs


def _open_text(path: str) -> io.TextIOBase:
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"))
    return open(path, "r")


def iter_exons(path: str) -> Iterable[Exon]:
    """Yield exon records from a GTF file (plain or gzipped)."""
    with _open_text(path) as fh:
        yield from iter_exons_lines(fh)


def iter_exons_lines(lines: Iterable[str]) -> Iterable[Exon]:
    for line in lines:
        if not line or line.startswith("#"):
            continue
        fields = line.rstrip("\n").split("\t")
        if len(fields) < 9 or fields[2] != "exon":
            continue
        attrs = _parse_attrs(fields[8])
        gene_id = attrs.get("gene_id", "")
        tx_id = attrs.get("transcript_id", "")
        if not gene_id or not tx_id:
            continue
        yield Exon(
            chrom=fields[0],
            start=int(fields[3]) - 1,
            end=int(fields[4]),
            strand=fields[6],
            gene_id=gene_id,
            gene_name=attrs.get("gene_name", gene_id),
            transcript_id=tx_id,
        )
