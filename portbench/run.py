"""Run one cell of the benchmark of irfinder_tpu_torch on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cells are the ``workloads`` of
BENCHMARK.json; harness.py says what a run does.  The last line of
standard output is the result's JSON object.  Without the cards the cell
asks for, the run exits with a non-zero code and prints no result.
"""

import time

T_PROC0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Caches of compilers the program may call, at fixed paths inside the
    checkout; the semantics overrides of the program's environment off (the
    reference pins every constant)."""
    cache = os.path.join(ROOT, ".portbench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ.pop("IRTPU_SEMANTICS", None)


if __name__ == "__main__":
    _environment()
    sys.path[0] = ROOT  # the checkout, not this folder: its modules are portbench.*
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T_PROC0))
