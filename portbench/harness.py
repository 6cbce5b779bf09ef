"""The benchmark of irfinder_tpu_torch: one run of one cell.

A cell (``workloads`` in BENCHMARK.json) names a configuration
(``configs/<name>.json``: the map and the sample depth) and a traffic mix
(``traffic/<name>.json``, read by inputs.py).  A run:

1. set-up: makes the map and the BAMs from ``--seed`` (inputs.py), hands
   the map to the program as data, and warms the entry point up on short
   samples of the cell's shape (the kernels load or build here);
2. the window: calls the entry point (``run_bam``, or ``run_multi_bam``
   for a traffic of several samples a call) back to back, as a pipeline
   runs one job after another, starting no call after ``--seconds``; the
   last call that started finishes.  A traffic file with ``"long_reads":
   true`` runs ``run_bam(..., config=RunConfig(long_reads=True))``, the
   port's ``BAM --long-reads`` mode: RunConfig's other fields default to
   what run_bam takes without one (``cap_frags`` 1 << 15, 4 decoder
   threads), so only the batch geometry changes.  run_multi_bam takes no
   RunConfig, so such a traffic runs one sample a call; without the key
   the entry point is called with no ``config``;
3. the check: the plain reference (reference/) works out every table of
   each input, and every sample's tables are compared with it
   line by line; each count of differing lines has the limit 0;
4. the metrics: each is read by its own reader, ``metrics/<name>.py``
   (``read(run) -> float | None``; None leaves the metric out).  With
   ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
   per-layer metrics, from a torch.profiler trace of the window (trace.py).

The last line of standard output is the result's JSON object; the checks
are also the last lines of standard error.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

from . import inputs as I
from . import trace as T

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "irfinder_tpu")


class NoDevice(SystemExit):
    pass


@dataclasses.dataclass
class Spec:
    cell: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


@dataclasses.dataclass
class Call:
    #: the input each of its samples reads
    inputs: list
    out_dirs: list
    start: float
    end: float
    #: RunMetrics of each sample, or None when the call raised
    metrics: list | None


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read."""

    spec: Spec
    ref: object  # the frozen CompiledRef
    inputs: list  # inputs.Input, one for each sample of a call
    calls: list
    t_start: float
    t_end: float
    setup_s: float
    #: torch.cuda.max_memory_allocated over the window (0 off the card)
    peak_bytes: int
    device_name: str
    trace: T.Trace | None = None
    #: input -> (aligned blocks, fragments) by the reference's decode
    decoded: dict = dataclasses.field(default_factory=dict)

    @property
    def completed(self) -> list:
        """(input index, RunMetrics) of every sample of a call that returned."""
        return [(i, m) for c in self.calls if c.metrics is not None
                for i, m in zip(c.inputs, c.metrics)]


def _for_cell(entries: list, cell: str) -> list:
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def load_spec(workload: str, overrides: dict | None = None) -> Spec:
    """The cell's entries and files, found by name in BENCHMARK.json."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)
    for part, over in (overrides or {}).items():
        {"config": config, "traffic": traffic}[part].update(over)
    if traffic.get("long_reads") and int(traffic["samples_per_call"]) != 1:
        raise SystemExit(f"traffic {cell['traffic']!r}: long_reads needs samples_per_call 1; "
                         "run_multi_bam, which runs several samples a call, takes no RunConfig")
    return Spec(cell, config, traffic, _for_cell(bench["end_to_end"], workload),
                _for_cell(bench["per_layer"], workload))


def check_device(chips: int) -> None:
    """Raises NoDevice unless the cell's cards are present."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < chips:
        raise NoDevice(f"portbench: the cell needs {chips} CUDA device(s); "
                       f"torch.cuda.is_available()={torch.cuda.is_available()}, device_count={n}")


def reader(name: str):
    """The ``read`` function of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def lines_differ(got: bytes, want: bytes) -> int:
    """Lines of ``got`` that differ from ``want``, position by position, plus
    the difference in their numbers of lines."""
    if got == want:
        return 0
    a, b = got.splitlines(), want.splitlines()
    n = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    return max(n, 1)  # a difference in line ends alone is one line


def compare(out_dir: str, expected: dict) -> dict:
    """{table: differing lines, or None when the file is missing}."""
    out = {}
    for name, want in expected.items():
        path = os.path.join(out_dir, name)
        if not os.path.exists(path):
            out[name] = None
            continue
        with open(path, "rb") as fh:
            out[name] = lines_differ(fh.read(), want)
    return out


#: check name of each compared table
CHECK_NAMES = {
    "IRFinder-IR-nondir.txt": "ir_nondir_lines",
    "IRFinder-IR-dir.txt": "ir_dir_lines",
    "IRFinder-JuncCount.txt": "junc_count_lines",
    "IRFinder-SpansPoint.txt": "spans_point_lines",
    "IRFinder-ROI.txt": "roi_lines",
    "IRFinder-ChrCoverage.txt": "chr_coverage_lines",
    "WARNINGS": "warnings_lines",
}


def _reference(ref, path: str) -> tuple:
    """({table: bytes}, (aligned blocks, fragments)) of one input by the
    plain reference."""
    from . import reference as R

    sizes: dict = {}
    want = {k: v.encode() for k, v in R.sample_tables(ref, path, sizes=sizes).items()}
    return want, (sizes["blocks"], sizes["fragments"])


def check_tables(calls: list, inputs: list, ref, log) -> tuple:
    """Every sample's tables against the reference's tables of its input.
    Returns (checks {name: differing lines}, failed samples, {input:
    (blocks, fragments)}).  A sample of a call that raised, or with a table
    missing, is failed; its tables are not compared.  Several inputs are
    worked out at once, one process each."""
    checks = {n: 0 for n in CHECK_NAMES.values()}
    failed = sum(len(c.inputs) for c in calls if c.metrics is None)
    decoded = {}
    used = sorted({i for c in calls if c.metrics is not None for i in c.inputs})
    t0 = time.perf_counter()
    if len(used) > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(min(len(used), os.cpu_count() or 1),
                                 mp_context=multiprocessing.get_context("spawn")) as ex:
            done = list(ex.map(_reference, [ref] * len(used), [inputs[i].path for i in used]))
    else:
        done = [_reference(ref, inputs[i].path) for i in used]
    log(f"reference: {len(used)} input(s) worked out in {time.perf_counter() - t0:.3f} s")
    for i, (want, sizes) in zip(used, done):
        decoded[i] = sizes
        t1 = time.perf_counter()
        n = 0
        for c in calls:
            if c.metrics is None:
                continue
            for j, out_dir in zip(c.inputs, c.out_dirs):
                if j != i:
                    continue
                n += 1
                diff = compare(out_dir, want)
                if any(v is None for v in diff.values()):
                    failed += 1
                    continue
                for name, v in diff.items():
                    checks[CHECK_NAMES[name]] += v
        log(f"reference: input {i}: {inputs[i].records} records; "
            f"{n} samples compared in {time.perf_counter() - t1:.3f} s")
    return checks, failed, decoded


def _bytes_under(path: str, prefix: str = "") -> int:
    """Bytes of the files under ``path`` whose names start with ``prefix``
    (the top level only when a prefix is given)."""
    if prefix:
        return sum(e.stat().st_size for e in os.scandir(path)
                   if e.is_file() and e.name.startswith(prefix))
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        return r.stdout.strip().replace("\n", "; ") or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_proc0: float,
             device: str = "cuda", overrides: dict | None = None, log=None) -> dict:
    """One run of ``workload``; returns the result object.  ``device`` and
    ``overrides`` ({"config": {...}, "traffic": {...}}) are for the CPU
    tests, which drive a run at a small size without a card."""
    log = log or (lambda s: print(s, flush=True))
    spec = load_spec(workload, overrides)
    import torch

    from irfinder_tpu_torch.config import RunConfig
    from irfinder_tpu_torch.convert import compiled_ref_from_numpy
    from irfinder_tpu_torch.engine import run_bam, run_multi_bam

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    tr = spec.traffic
    spc = int(tr["samples_per_call"])
    base = os.environ.get("TMPDIR") or None
    work = tempfile.mkdtemp(prefix="portbench-", dir=base)
    try:
        t0 = time.perf_counter()
        ref = I.make_map(spec.config)
        pref = compiled_ref_from_numpy({f.name: getattr(ref, f.name)
                                        for f in dataclasses.fields(ref)})
        t1 = time.perf_counter()
        inputs, warm = I.make_inputs(work, ref, spec.config, tr, seed)
        t2 = time.perf_counter()
        log(f"set-up: map {t1 - t0:.3f} s ({ref.n_introns} introns, {ref.mbs_size} measured "
            f"bases); inputs {t2 - t1:.3f} s ({len(inputs)} x {inputs[0].records} records, "
            f"warm-up {len(warm)} x {warm[0].records})")

        mode = {"config": RunConfig(long_reads=True)} if tr.get("long_reads") else {}

        def call(paths: list, outs: list) -> list:
            if spc == 1:
                return [run_bam(pref, paths[0], outs[0], device=dev, **mode)]
            return run_multi_bam(pref, paths, outs, device=dev)

        built = os.path.isdir(os.path.join(ROOT, "irfinder_tpu_torch", "_build"))
        call([w.path for w in warm], [os.path.join(work, "warmup", str(i)) for i in range(spc)])
        if cuda:
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        log(f"set-up: warm-up {t3 - t2:.3f} s (program build cache "
            f"{'present' if built else 'absent: built here'})")
        setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        gc.collect()

        calls = []
        entry = "run_bam" if spc == 1 else f"run_multi_bam x{spc}"
        with T.Recorder(trace, work) as rec:
            t_start = time.perf_counter()
            with rec.span("window"):
                while time.perf_counter() - t_start < seconds:
                    k = len(calls)
                    idx = list(range(spc))
                    outs = [os.path.join(work, "out", str(k * spc + i)) for i in range(spc)]
                    with rec.span(f"call {k} {entry}"):
                        c0 = time.perf_counter()
                        try:
                            ms = call([inputs[i].path for i in idx], outs)
                        except Exception:  # a failed sample is counted, not fatal
                            traceback.print_exc()
                            ms = None
                        c1 = time.perf_counter()
                    calls.append(Call(idx, outs, c0, c1, ms))
        t_end = calls[-1].end
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        log(f"window: {len(calls)} calls of {spc} sample(s) in {t_end - t_start:.3f} s; "
            f"walls {', '.join(f'{c.end - c.start:.3f}' for c in calls)}")

        run = Run(spec, ref, inputs, calls, t_start, t_end, t_start - t_proc0, peak,
                  torch.cuda.get_device_name(dev) if cuda else str(dev), rec.result)
        del pref
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        log(f"disk: inputs {_bytes_under(work, 'input')} bytes, warm-up inputs "
            f"{_bytes_under(work, 'warmup')} bytes, the window's tables "
            f"{_bytes_under(os.path.join(work, 'out'))} bytes")
        t4 = time.perf_counter()
        checks, failed, run.decoded = check_tables(calls, inputs, ref, log)
        log(f"reference: {time.perf_counter() - t4:.3f} s")

        metrics = {}
        for m in (spec.per_layer if trace else spec.end_to_end):
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_out = {"platform": "gpu" if cuda else dev.type, "kind": run.device_name,
                   "count": int(spec.cell["chips"]), "memory_peak_bytes": int(max(setup_peak, peak))}
        result = {
            "correct": failed == 0 and not any(checks.values()),
            "attempted": sum(len(c.inputs) for c in calls),
            "failed": failed,
            "metrics": metrics,
            "device": dev_out,
        }
        if run.trace is not None:
            dev_out["busy_s"] = run.trace.busy_s
            dev_out["window_s"] = run.trace.window_s
            result["breakdown"] = T.breakdown(run.trace)
        result["checks"] = {"samples_failed": {"value": failed, "limit": 0},
                            **{k: {"value": v, "limit": 0} for k, v in checks.items()}}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv: list, t_proc0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/run.py", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    spec = load_spec(a.workload)
    check_device(int(spec.cell["chips"]))
    print(f"device: {power_limit()}", flush=True)
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t_proc0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded in this process: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
