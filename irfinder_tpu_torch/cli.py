"""Command-line interface of the port: the ``BAM`` and ``Batch`` modes of
irfinder_tpu.cli.

Usage:  python -m irfinder_tpu_torch.cli BAM -r REF -d OUT input.bam
        python -m irfinder_tpu_torch.cli Batch -r REF -d OUT a.bam b.bam ...
            [--a 0,1 --b 2,3]

The flags are irfinder_tpu.cli's, plus ``--device`` (default ``cuda``: a
host without a card fails unless ``--device cpu`` is given).
``--checkpoint`` and ``--mesh`` and every other mode are not yet ported and
exit non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: irfinder_tpu.cli modes that the port does not have yet
NOT_PORTED = (
    "BuildRef", "BuildRefProcess", "BuildRefFromSTARRef", "BuildRefDownload",
    "Mapability", "ExportGLM", "FastQ", "Diff", "Goldens",
)


def _not_ported(what: str) -> int:
    sys.stderr.write(
        f"irfinder_tpu_torch: {what} is not yet ported; use python -m irfinder_tpu.cli\n"
    )
    return 2


def cmd_bam(args) -> int:
    import shutil

    from irfinder_tpu.config import RunConfig
    from irfinder_tpu.refio.compile import CompiledRef

    from .engine import run_bam

    if args.mesh:
        return _not_ported("--mesh")
    if args.checkpoint:
        return _not_ported("--checkpoint")
    ref = CompiledRef.load(args.ref)
    cfg = RunConfig.from_args(args)

    def run():
        m = run_bam(ref, args.bam, args.out, config=cfg, device=args.device)
        if args.keep_bam:
            # Unsorted.bam pass-through: BAM mode's input already is the
            # unsorted stream; link or copy it next to the tables
            dst = os.path.join(args.out, "Unsorted.bam")
            if os.path.abspath(args.bam) != os.path.abspath(dst):
                try:
                    if os.path.exists(dst):
                        os.remove(dst)
                    os.link(args.bam, dst)
                except OSError:
                    shutil.copyfile(args.bam, dst)
        return m

    if args.profile:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            metrics = run()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        metrics = run()
    print(json.dumps(metrics.as_dict(), indent=1))
    return 0


def cmd_batch(args) -> int:
    """Batch mode (BASELINE config D): N BAMs streamed concurrently through
    one engine, one output subdirectory per sample; optional pooled
    differential between two sample-index groups (shared irfinder_tpu.diff)."""
    from irfinder_tpu.refio.compile import CompiledRef

    from .engine import run_multi_bam

    ref = CompiledRef.load(args.ref)
    names = [os.path.splitext(os.path.basename(b))[0] for b in args.bams]
    # de-duplicate repeated basenames
    seen: dict = {}
    for i, n in enumerate(names):
        if n in seen:
            names[i] = f"{n}.{i}"
        seen[n] = i
    out_dirs = [os.path.join(args.out, n) for n in names]
    metrics = run_multi_bam(
        ref, args.bams, out_dirs, use_native=not args.no_native, device=args.device
    )
    print(json.dumps({n: m.as_dict() for n, m in zip(names, metrics)}, indent=1))
    if args.a and args.b:
        from irfinder_tpu.diff import run_differential

        def sel(idxs):
            return [out_dirs[int(i)] for i in idxs.split(",")]

        return run_differential(
            cond_a=sel(args.a),
            cond_b=sel(args.b),
            out_path=os.path.join(args.out, "IRFinder-Diff.txt"),
            min_cov=None,
        )
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="irfinder-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("BAM", help="count an aligner-ordered BAM")
    c.add_argument("-r", "--ref", required=True, help="reference directory from BuildRef")
    c.add_argument("-d", "--out", required=True, help="output directory")
    c.add_argument("bam", help="input BAM in aligner output order")
    c.add_argument("--profile", help="write a torch.profiler chrome trace to this directory")
    c.add_argument("--checkpoint", help="snapshot file for resumable runs (not yet ported)")
    c.add_argument(
        "--checkpoint-every", type=int, default=None, dest="checkpoint_every",
        help="batches between snapshots",
    )
    c.add_argument(
        "--cap-frags", type=int, default=None, dest="cap_frags",
        help="fragments per device batch",
    )
    c.add_argument(
        "--threads", type=int, default=None, dest="decoder_threads",
        help="native decoder worker threads",
    )
    c.add_argument("--no-native", action="store_true", help="force the Python decoder")
    c.add_argument(
        "--keep-bam", dest="keep_bam", action="store_true",
        help="also emit the input stream as <out>/Unsorted.bam (pass-through)",
    )
    c.add_argument("--mesh", help="sharded counting (not yet ported)")
    c.add_argument(
        "--long-reads", dest="long_reads", action="store_true",
        help="widen batch block/gap columns for many-block single-end alignments",
    )
    c.add_argument("--device", default="cuda", help="torch device to count on (default: cuda)")
    c.set_defaults(fn=cmd_bam)

    g = sub.add_parser("Batch", help="multi-sample batch mode (N concurrent BAMs)")
    g.add_argument("-r", "--ref", required=True, help="reference directory from BuildRef")
    g.add_argument("-d", "--out", required=True, help="output root (one subdir per sample)")
    g.add_argument("bams", nargs="+", help="input BAMs in aligner output order")
    g.add_argument("--a", help="comma-separated sample indices of condition A (differential)")
    g.add_argument("--b", help="comma-separated sample indices of condition B")
    g.add_argument("--no-native", action="store_true", help="force the Python decoder")
    g.add_argument("--device", default="cuda", help="torch device to count on (default: cuda)")
    g.set_defaults(fn=cmd_batch)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        return _not_ported(f"mode {argv[0]}")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
