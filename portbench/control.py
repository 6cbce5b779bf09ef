"""The control of the benchmark's correctness check: the plain reference put
in the program's place, with its per-intron statistics computed in float32,
the nearest precision below the float64 that the configurations state.
The check has to find it not correct.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs as a run does (the cell's own
sizes) and prints, for each input, the comparison's numbers for
the control's tables against the reference's, then one JSON line per
seed: the smallest reading of each number over the inputs and whether
the run would be correct.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

if __package__ in (None, ""):
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness as H  # noqa: E402
from portbench import inputs as I  # noqa: E402
from portbench import reference as R  # noqa: E402


def control_checks(ref, bam: str) -> dict:
    """{check name: lines in which the float32 control's tables differ
    from the reference's} for one BAM."""
    want = R.sample_tables(ref, bam)
    got = R.sample_tables(ref, bam, real=np.float32)
    return {H.CHECK_NAMES[k]: H.lines_differ(got[k].encode(), want[k].encode()) for k in want}


def run(workload: str, seed: int, overrides: dict | None = None, log=print) -> dict:
    spec = H.load_spec(workload, overrides)
    ref = I.make_map(spec.config)
    work = tempfile.mkdtemp(prefix="portbench-control-", dir=os.environ.get("TMPDIR") or None)
    try:
        inputs, _ = I.make_inputs(work, ref, spec.config, spec.traffic, seed)
        per_input = []
        for i, inp in enumerate(inputs):
            t0 = time.perf_counter()
            c = control_checks(ref, inp.path)
            log(f"control: {workload} seed {seed} input {i} ({inp.records} records, "
                f"{time.perf_counter() - t0:.3f} s): {c}")
            per_input.append(c)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    least = {k: min(c[k] for c in per_input) for k in per_input[0]}
    return {"workload": workload, "seed": seed, "least": least,
            "correct": not any(least.values())}


def main(argv: list) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    for s in a.seeds:
        print(json.dumps(run(a.workload, s)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
