"""The exon record the reference compiler consumes (refio/compile.py).

The port's copy of irfinder_tpu/refio/gtf.py keeps only the record: the
port compiles references from synthetic exons (synth.py) and loads saved
ones; the GTF file parser is not ported.  Coordinates are 0-based half-open.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Exon:
    chrom: str
    start: int  # 0-based
    end: int  # exclusive
    strand: str  # '+' or '-'
    gene_id: str
    gene_name: str
    transcript_id: str
