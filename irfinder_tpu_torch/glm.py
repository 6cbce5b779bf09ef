"""GLM (DESeq2) export, the port's copy of irfinder_tpu/glm.py: the
executable half of the reference's `bin/DESeq2Constructor.R` route
(construction in docs/GLM_DIFFERENTIAL.md).

The R helper `DESeqDataSetFromIRFinder` consumed one intronic + one spliced
count per intron per sample and fit `~ condition + condition:IRFinder`; this
module writes exactly that input from the IR tables:

  GLM-counts.tsv   introns x (2*samples) integer matrix; one `<sample>.IR`
                   column per sample (round(IntronDepth)) followed by one
                   `<sample>.Splice` column per sample (SpliceExact)
  GLM-coldata.tsv  one row per matrix column: sample, IRFinder (IR|Splice),
                   condition — ready for DESeqDataSetFromMatrix
"""

from __future__ import annotations

import os

IR_TABLE = "IRFinder-IR-{mode}.txt"


def read_ir_table(path: str) -> tuple[list, list, list]:
    """Returns (row_ids, intronic_counts, spliced_counts) from one IR table.
    Row id = Chr:Start-End/Name/Strand (stable join key across samples)."""
    ids, intronic, spliced = [], [], []
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        col = {c: i for i, c in enumerate(header)}
        need = ("Chr", "Start", "End", "Name", "Strand", "IntronDepth", "SpliceExact")
        missing = [c for c in need if c not in col]
        if missing:
            raise ValueError(f"{path}: missing IR-table columns {missing}")
        for ln in fh:
            f = ln.rstrip("\n").split("\t")
            ids.append(
                f"{f[col['Chr']]}:{f[col['Start']]}-{f[col['End']]}"
                f"/{f[col['Name']]}/{f[col['Strand']]}"
            )
            # round() matches the documented R-side `round(tab$IntronDepth)`
            intronic.append(round(float(f[col["IntronDepth"]])))
            spliced.append(int(f[col["SpliceExact"]]))
    return ids, intronic, spliced


def export_glm(
    sample_dirs: list,
    out_dir: str,
    conditions: list | None = None,
    mode: str = "nondir",
    sample_names: list | None = None,
) -> tuple[str, str]:
    """Write GLM-counts.tsv + GLM-coldata.tsv from N sample result dirs.

    conditions: one label per sample (default: all 'A' — edit the coldata).
    Returns the two output paths."""
    if sample_names is None:
        sample_names = [os.path.basename(os.path.normpath(d)) for d in sample_dirs]
    if conditions is None:
        conditions = ["A"] * len(sample_dirs)
    if len(conditions) != len(sample_dirs):
        raise ValueError(
            f"{len(conditions)} conditions for {len(sample_dirs)} samples"
        )
    table = IR_TABLE.format(mode=mode)
    ids0 = None
    intr_cols, spl_cols = [], []
    for d in sample_dirs:
        ids, intronic, spliced = read_ir_table(os.path.join(d, table))
        if ids0 is None:
            ids0 = ids
        elif ids != ids0:
            raise ValueError(
                f"{d}/{table}: intron rows differ from {sample_dirs[0]} — "
                "samples must be counted against the same reference"
            )
        intr_cols.append(intronic)
        spl_cols.append(spliced)

    os.makedirs(out_dir, exist_ok=True)
    counts_path = os.path.join(out_dir, "GLM-counts.tsv")
    coldata_path = os.path.join(out_dir, "GLM-coldata.tsv")
    with open(counts_path, "w") as fh:
        cols = [f"{s}.IR" for s in sample_names] + [
            f"{s}.Splice" for s in sample_names
        ]
        fh.write("intron\t" + "\t".join(cols) + "\n")
        all_cols = intr_cols + spl_cols
        for i, rid in enumerate(ids0):
            fh.write(rid + "\t" + "\t".join(str(c[i]) for c in all_cols) + "\n")
    with open(coldata_path, "w") as fh:
        fh.write("column\tsample\tIRFinder\tcondition\n")
        for s, c in zip(sample_names, conditions):
            fh.write(f"{s}.IR\t{s}\tIR\t{c}\n")
        for s, c in zip(sample_names, conditions):
            fh.write(f"{s}.Splice\t{s}\tSplice\t{c}\n")
    return counts_path, coldata_path
