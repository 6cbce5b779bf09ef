"""Command-line interface of the port: the ``BAM``, ``Batch`` and ``FastQ``
modes of irfinder_tpu.cli.

Usage:  python -m irfinder_tpu_torch.cli BAM -r REF -d OUT input.bam
            [--checkpoint STATE.npz [--checkpoint-every N]]
            [--mesh dp=N,genome=G[,routed]]
        python -m irfinder_tpu_torch.cli Batch -r REF -d OUT a.bam b.bam ...
            [--a 0,1 --b 2,3]
        python -m irfinder_tpu_torch.cli FastQ -r REF -d OUT r1.fq [r2.fq]
            --aligner-cmd 'ALIGNER {r1} {r2}' [--trim] [--stream] [--keep-bam]

The flags are irfinder_tpu.cli's, plus ``--device`` (default ``cuda``: a
host without a card fails unless ``--device cpu`` is given).  ``BAM --mesh``
counts over engine_mesh.py's mesh, its cells on every card (``cuda``) or all
on one device (``cpu``, ``cuda:K``); ``genome=G`` alone with fewer cards
than G runs unsharded.  The other modes are not yet ported and exit
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

#: irfinder_tpu.cli modes that the port does not have yet
NOT_PORTED = (
    "BuildRef", "BuildRefProcess", "BuildRefFromSTARRef", "BuildRefDownload",
    "Mapability", "ExportGLM", "Diff", "Goldens",
)


def _not_ported(what: str) -> int:
    sys.stderr.write(
        f"irfinder_tpu_torch: {what} is not yet ported; use python -m irfinder_tpu.cli\n"
    )
    return 2


def cmd_bam(args) -> int:
    import shutil

    from .config import RunConfig
    from .engine import run_bam
    from .engine_mesh import MeshSpec, run_bam_mesh
    from .refio.compile import CompiledRef

    spec = MeshSpec.parse(args.mesh) if args.mesh else None
    ref = CompiledRef.load(args.ref)
    cfg = RunConfig.from_args(args)

    def run():
        if spec is None:
            m = run_bam(ref, args.bam, args.out, config=cfg, device=args.device)
        else:
            m = run_bam_mesh(ref, args.bam, args.out, spec, config=cfg, device=args.device)
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
    differential between two sample-index groups (diff.py)."""
    from .engine import run_multi_bam
    from .refio.compile import CompiledRef

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
        from .diff import run_differential

        def sel(idxs):
            return [out_dirs[int(i)] for i in idxs.split(",")]

        return run_differential(
            cond_a=sel(args.a),
            cond_b=sel(args.b),
            out_path=os.path.join(args.out, "IRFinder-Diff.txt"),
            min_cov=None,
        )
    return 0


class _TeeReader:
    """Read-through wrapper that copies every chunk to a sink file (FastQ
    --stream --keep-bam: spool Unsorted.bam while counting off the pipe).

    Exposes fileno()/tell() so engine.open_decoder can route the underlying
    pipe through the native streaming decoder, which tees in C via
    ``irtpu_tee_fd``; the Python read() tee below runs only on the
    pure-Python decoder's path, so exactly one of them writes the copy."""

    def __init__(self, src, sink):
        self._src = src
        self._sink = sink
        self.irtpu_tee_fd = sink.fileno()

    def fileno(self) -> int:
        return self._src.fileno()

    def tell(self) -> int:
        return self._src.tell()

    def read(self, n: int = -1) -> bytes:
        data = self._src.read(n)
        if data:
            self._sink.write(data)
        return data

    def close_sink(self) -> None:
        self._sink.close()


def cmd_fastq(args) -> int:
    """The full FastQ pipeline: optional adapter trimming -> external
    aligner subprocess -> counting engine, wired by pipes as the reference's
    trim | STAR | irfinder.

    The aligner command is user-supplied (``--aligner-cmd``, ``{r1}``/``{r2}``
    placeholders) and must write an unsorted BAM (aligner output order, mates
    adjacent) to stdout, e.g. for STAR:

        --aligner-cmd 'STAR --genomeDir IDX --readFilesIn {r1} {r2}
                       --outSAMtype BAM Unsorted --outStd BAM_Unsorted
                       --outSAMunmapped Within --runThreadN 8'

    By default the aligner BAM is spooled next to the outputs and counted
    from the file (removed afterwards unless --keep-bam); --stream counts
    straight off the pipe instead, overlapping counting with alignment."""
    import shlex
    import shutil
    import subprocess

    from .engine import run_bam
    from .refio.compile import CompiledRef

    if not args.aligner_cmd:
        sys.stderr.write(
            "FastQ mode needs --aligner-cmd (external aligner writing an\n"
            "unsorted BAM to stdout); alignment itself is external to the\n"
            "engine.  Alternatively align separately and use BAM mode.\n"
        )
        return 2
    ref = CompiledRef.load(args.ref)
    r1, r2 = args.r1, args.r2

    if args.trim:
        # the native adapter trimmer as a filter before the aligner: trimmed
        # FASTQs are written next to the outputs and fed to the aligner
        from .native.trim_native import trim_binary

        os.makedirs(args.out, exist_ok=True)
        t1 = os.path.join(args.out, "trimmed_1.fastq")
        t2 = os.path.join(args.out, "trimmed_2.fastq") if r2 else os.devnull
        rc = subprocess.call([trim_binary(), r1, r2 or os.devnull, t1, t2])
        if rc != 0:
            sys.stderr.write(f"trim failed with exit code {rc}\n")
            return rc
        r1, r2 = t1, (t2 if r2 else None)

    cmd = args.aligner_cmd.format(r1=r1, r2=r2 or "")
    aligner = subprocess.Popen(shlex.split(cmd), stdout=subprocess.PIPE)
    try:
        if args.stream:
            # count straight off the pipe: open_decoder routes a fresh pipe
            # through the native streaming decoder
            src = aligner.stdout
            if args.keep_bam:
                os.makedirs(args.out, exist_ok=True)
                src = _TeeReader(
                    aligner.stdout, open(os.path.join(args.out, "Unsorted.bam"), "wb")
                )
            try:
                metrics = run_bam(ref, src, args.out, device=args.device)
            finally:
                if args.keep_bam:
                    src.close_sink()
        else:
            os.makedirs(args.out, exist_ok=True)
            bam_path = os.path.join(args.out, "Unsorted.bam")
            with open(bam_path, "wb") as fh:
                shutil.copyfileobj(aligner.stdout, fh)
            metrics = run_bam(ref, bam_path, args.out, device=args.device)
            if not args.keep_bam:
                os.remove(bam_path)
    finally:
        aligner.stdout.close()
        rc = aligner.wait()
    if rc != 0:
        sys.stderr.write(f"aligner exited with code {rc}\n")
        return rc
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
    c.add_argument("--checkpoint", help="snapshot file for resumable runs")
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
    c.add_argument(
        "--mesh",
        help="sharded counting over a dp x genome mesh: dp=N,genome=G[,routed] "
        "(cells on --device: every card for cuda, repeated for cpu or cuda:K)",
    )
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

    f = sub.add_parser("FastQ", help="trim -> external aligner pipe -> count (full pipeline)")
    f.add_argument("-r", "--ref", required=True, help="reference directory from BuildRef")
    f.add_argument("-d", "--out", required=True, help="output directory")
    f.add_argument("r1", help="FASTQ mate 1")
    f.add_argument("r2", nargs="?", default=None, help="FASTQ mate 2 (paired-end)")
    f.add_argument(
        "--aligner-cmd", dest="aligner_cmd",
        help="aligner command template writing unsorted BAM to stdout; "
        "{r1}/{r2} expand to the (possibly trimmed) FASTQ paths",
    )
    f.add_argument("--trim", action="store_true", help="adapter-trim before aligning")
    f.add_argument(
        "--keep-bam", dest="keep_bam", action="store_true",
        help="keep the aligner BAM as <out>/Unsorted.bam",
    )
    f.add_argument(
        "--stream", action="store_true",
        help="count straight off the aligner pipe (no BAM on disk)",
    )
    f.add_argument("--device", default="cuda", help="torch device to count on (default: cuda)")
    f.set_defaults(fn=cmd_fastq)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        return _not_ported(f"mode {argv[0]}")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
