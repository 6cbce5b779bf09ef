"""Command-line interface of the port: the ``BAM`` mode of irfinder_tpu.cli.

Usage:  python -m irfinder_tpu_torch.cli BAM -r REF -d OUT input.bam

The flags are irfinder_tpu.cli's BAM flags.  ``--checkpoint`` and ``--mesh``
and every other mode are not yet ported and exit non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: irfinder_tpu.cli modes that the port does not have yet
NOT_PORTED = (
    "BuildRef", "BuildRefProcess", "BuildRefFromSTARRef", "BuildRefDownload",
    "Mapability", "ExportGLM", "Batch", "FastQ", "Diff", "Goldens",
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
        m = run_bam(ref, args.bam, args.out, config=cfg)
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
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            metrics = run()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    else:
        metrics = run()
    print(json.dumps(metrics.as_dict(), indent=1))
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
    c.set_defaults(fn=cmd_bam)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        return _not_ported(f"mode {argv[0]}")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
