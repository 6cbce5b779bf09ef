"""Golden-file conformance harness, the port's copy of irfinder_tpu/goldens.py.

Every `[R:verify]` constant in semantics.py must be pinned against reference
IRFinder outputs the first time goldens are available.  This module is the
pinning tool:

    python -m irfinder_tpu_torch.goldens OURS_DIR GOLDEN_DIR [--record OUT.json]

compares every output table byte-wise and, on mismatch, localizes the first
divergence to (table, line, column) and names the semantics constants that
govern that column — turning a golden diff into a short list of knobs to
re-derive (docs/GOLDEN_PINNING.md).  ``--record`` writes the port's own
live ``semantics.SEMANTICS_OVERRIDES`` into the pinning record.
"""

from __future__ import annotations

import os
import sys

#: Output table -> the semantics constants that shape each column family.
COLUMN_KNOBS = {
    "IRFinder-IR-nondir.txt": {
        "Coverage": ["EXON_EXCLUSION_BUFFER", "INTRON_EDGE_TRIM", "ANTI_NEAR_DIST"],
        "IntronDepth": ["MATE_OVERLAP_DOUBLE_COUNTS", "MIN_MAPQ", "FLAG_DROP_MASK"],
        "IntronDepth25thPercentile": ["percentile_rank_index"],
        "IntronDepth50thPercentile": ["percentile_rank_index"],
        "IntronDepth75thPercentile": ["percentile_rank_index"],
        "ExonToIntronReadsLeft": ["SPANS_OVERHANG"],
        "ExonToIntronReadsRight": ["SPANS_OVERHANG"],
        "IntronDepthFirst50bp": ["EDGE_DEPTH_WINDOW"],
        "IntronDepthLast50bp": ["EDGE_DEPTH_WINDOW"],
        "SpliceLeft": ["MIN_GAP_AS_JUNCTION"],
        "SpliceRight": ["MIN_GAP_AS_JUNCTION"],
        "SpliceExact": ["MIN_GAP_AS_JUNCTION"],
        "IRratio": ["IR_DENOMINATOR (finalize/format)"],
        "Warnings": [
            "WARN_LOW_COVER_DEPTH",
            "WARN_LOW_SPLICING_COUNT",
            "WARN_MINOR_ISOFORM_MULT",
            "WARN_NONUNIFORM_IQR_VS_MEAN",
            "WARNING_ORDER",
        ],
        "Name": ["INTRON_CLASSES", "ANTI_NEAR_DIST"],
    },
    "IRFinder-IR-dir.txt": {
        "*": ["DIR_CONCORDANCE_THRESHOLD", "DIR_MIN_INFORMATIVE"],
    },
    "IRFinder-JuncCount.txt": {"*": ["MIN_GAP_AS_JUNCTION"]},
    "IRFinder-SpansPoint.txt": {"*": ["SPANS_OVERHANG"]},
    "IRFinder-ROI.txt": {"*": []},
    "IRFinder-ChrCoverage.txt": {"*": []},
}


def compare_table(ours_path: str, gold_path: str) -> dict:
    """Byte compare; on mismatch localize first divergent line/column."""
    name = os.path.basename(ours_path)
    with open(ours_path, "rb") as fh:
        ours = fh.read()
    with open(gold_path, "rb") as fh:
        gold = fh.read()
    if ours == gold:
        return {"table": name, "match": True}
    o_lines = ours.decode(errors="replace").splitlines()
    g_lines = gold.decode(errors="replace").splitlines()
    header = o_lines[0].split("\t") if o_lines else []
    for i, (a, b) in enumerate(zip(o_lines, g_lines)):
        if a != b:
            ac, bc = a.split("\t"), b.split("\t")
            for j, (x, y) in enumerate(zip(ac, bc)):
                if x != y:
                    col = header[j] if j < len(header) and i > 0 else f"col{j}"
                    knobs = COLUMN_KNOBS.get(name, {})
                    sus = knobs.get(col, knobs.get("*", []))
                    return {
                        "table": name,
                        "match": False,
                        "line": i + 1,
                        "column": col,
                        "ours": x,
                        "golden": y,
                        "suspect_constants": sus,
                    }
            return {
                "table": name,
                "match": False,
                "line": i + 1,
                "column": "(row length)",
                "ours": a[:80],
                "golden": b[:80],
                "suspect_constants": [],
            }
    return {
        "table": name,
        "match": False,
        "line": min(len(o_lines), len(g_lines)) + 1,
        "column": "(row count)",
        "ours": str(len(o_lines)),
        "golden": str(len(g_lines)),
        "suspect_constants": ["ref compiler intron set"],
    }


def check(ours_dir: str, golden_dir: str, record: str | None = None) -> int:
    """Compare all known tables present in both dirs; returns #mismatches.

    With `record`, writes a JSON pinning record: per-table verdicts, the
    localized first divergence + suspect constants for each mismatch, and the
    semantics overrides that were live during the comparison run — the
    artifact to commit next to semantics.py the day real goldens are pinned."""
    results = []
    bad = 0
    for name in COLUMN_KNOBS:
        a = os.path.join(ours_dir, name)
        b = os.path.join(golden_dir, name)
        if not os.path.exists(b):
            continue
        if not os.path.exists(a):
            print(f"{name}: MISSING from ours")
            results.append({"table": name, "match": False, "missing": "ours"})
            bad += 1
            continue
        r = compare_table(a, b)
        results.append(r)
        if r["match"]:
            print(f"{name}: MATCH (byte-identical)")
        else:
            bad += 1
            print(
                f"{name}: MISMATCH at line {r['line']}, column {r['column']}: "
                f"ours={r['ours']!r} golden={r['golden']!r}"
            )
            if r["suspect_constants"]:
                print(f"  -> re-derive semantics constants: {', '.join(r['suspect_constants'])}")
    if record:
        import datetime
        import json

        from . import semantics as S

        with open(record, "w") as fh:
            json.dump(
                {
                    "when": datetime.datetime.now().isoformat(timespec="seconds"),
                    "ours": os.path.abspath(ours_dir),
                    "golden": os.path.abspath(golden_dir),
                    "mismatches": bad,
                    "tables": results,
                    "semantics_overrides": S.SEMANTICS_OVERRIDES,
                    "pinned": bad == 0,
                },
                fh,
                indent=1,
            )
    return bad


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    record = None
    if "--record" in argv:
        i = argv.index("--record")
        record = argv[i + 1]
        argv = argv[:i] + argv[i + 2 :]
    if len(argv) != 2:
        sys.stderr.write(
            "usage: python -m irfinder_tpu_torch.goldens OURS_DIR GOLDEN_DIR [--record OUT.json]\n"
        )
        return 2
    return 1 if check(argv[0], argv[1], record=record) else 0


if __name__ == "__main__":
    raise SystemExit(main())
