"""Command-line interface of the port: every mode of irfinder_tpu.cli, with
the same flags and the same outputs.

  BuildRef   compile a GTF annotation into a reference directory
             (BuildRefProcess and BuildRefFromSTARRef are its aliases)
  BAM        count an aligner-ordered BAM
  Batch      count N BAMs through one engine, optional differential
  FastQ      optional adapter trim -> external aligner subprocess (unsorted
             BAM on stdout) -> counting engine off the pipe
  Diff       pooled small-replicate differential IR between two conditions
  ExportGLM  DESeq2 count matrix + coldata from sample result directories
  Goldens    byte-compare a result directory against golden outputs
  Mapability tile a FASTA into reads (generate) / aligned tiles -> exclusion
             BED (collect), around an external aligner
  BuildRefDownload  print how to fetch the inputs, or validate a manifest of
             fetched ones (no network access)

Usage:  python -m irfinder_tpu_torch.cli BuildRef -g ann.gtf -r REF [--roi roi.bed]
            [--exclude exclude.bed]
        python -m irfinder_tpu_torch.cli BAM -r REF -d OUT input.bam
            [--checkpoint STATE.npz [--checkpoint-every N]]
            [--mesh dp=N,genome=G[,routed]]
        python -m irfinder_tpu_torch.cli Batch -r REF -d OUT a.bam b.bam ...
            [--a 0,1 --b 2,3]
        python -m irfinder_tpu_torch.cli FastQ -r REF -d OUT r1.fq [r2.fq]
            --aligner-cmd 'ALIGNER {r1} {r2}' [--trim] [--stream] [--keep-bam]
        python -m irfinder_tpu_torch.cli Diff -a A1 A2 -b B1 B2 -d diff.txt
        python -m irfinder_tpu_torch.cli ExportGLM -d GLM S1 S2 [--conditions A,B] [--dir]
        python -m irfinder_tpu_torch.cli Goldens OURS GOLDEN [--record rec.json]
        python -m irfinder_tpu_torch.cli Mapability generate -f g.fa -o tiles.fq
        python -m irfinder_tpu_torch.cli Mapability collect -f g.fa -b tiles.bam -o excl.bed
        python -m irfinder_tpu_torch.cli BuildRefDownload [--manifest m.json]

The counting modes (BAM, Batch, FastQ) add ``--device`` (default ``cuda``: a
host without a card fails unless ``--device cpu`` is given).  ``BAM --mesh``
counts over engine_mesh.py's mesh, its cells on every card (``cuda``) or all
on one device (``cpu``, ``cuda:K``); ``genome=G`` alone with fewer cards
than G runs unsharded.  The other modes are host work and never touch the
card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _parse_bed(path: str):
    """Minimal BED reader: chrom start end [name [score [strand]]]."""
    rows = []
    with open(path) as fh:
        for ln in fh:
            ln = ln.strip()
            if not ln or ln.startswith(("#", "track", "browser")):
                continue
            f = ln.split("\t")
            name = f[3] if len(f) > 3 else f"{f[0]}:{f[1]}-{f[2]}"
            strand = f[5] if len(f) > 5 else "."
            rows.append((f[0], int(f[1]), int(f[2]), name, strand))
    return rows


def cmd_buildref(args) -> int:
    from .refio.compile import compile_reference
    from .refio.gtf import iter_exons

    rois = _parse_bed(args.roi) if args.roi else []
    extra = None
    if args.exclude:
        extra = {}
        for (c, s, e, _n, _st) in _parse_bed(args.exclude):
            extra.setdefault(c, ([], []))
            extra[c][0].append(s)
            extra[c][1].append(e)
    ref = compile_reference(iter_exons(args.gtf), rois=rois, extra_exclusions=extra)
    ref.save(args.ref)
    print(
        f"BuildRef: {ref.n_introns} introns over {ref.n_chroms} chromosomes, "
        f"{ref.mbs_size} measured bases -> {args.ref}"
    )
    return 0


def all_threads() -> dict:
    """torch.profiler.profile's keyword that records the ranges of every
    thread (the feeder threads' decode and stage spans), where the
    installed torch has it; else none, and only the calling thread's ranges
    are recorded."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    except (ImportError, TypeError):
        return {}


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
        with profile(activities=acts, **all_threads()) as prof:
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


def cmd_mapability(args) -> int:
    """The mappability exclusion halves around the external aligner
    (refio/mapgen.py; the reference's spelling of the mode)."""
    from . import semantics as S
    from .refio.mapgen import collect_exclusions, read_fasta, write_bed, write_tile_fastq

    read_len = args.read_len or S.MAPGEN_READ_LEN
    stride = args.stride or S.MAPGEN_STRIDE
    seqs = read_fasta(args.fasta)
    if args.action == "generate":
        with open(args.out, "wb") as fh:
            n = write_tile_fastq(seqs, fh, read_len, stride)
        print(f"Mapability: {n} synthetic tile reads -> {args.out}")
        return 0
    lengths = {c: len(s) for c, s in seqs.items()}
    rows = collect_exclusions(args.bam, lengths, read_len, stride)
    with open(args.out, "w") as fh:
        write_bed(rows, fh)
    print(f"Mapability: {len(rows)} exclusion intervals -> {args.out}")
    return 0


def cmd_buildref_download(args) -> int:
    """No network access in-process; with --manifest, validate pre-fetched
    inputs instead (gzip integrity, GTF/FASTA/BED shape)."""
    if args.manifest:
        return _validate_manifest(args.manifest)
    sys.stderr.write(
        "BuildRefDownload: this environment has no network egress; fetch the\n"
        "inputs yourself and run BuildRef:\n"
        "  1. Ensembl GTF:  https://ftp.ensembl.org/pub/release-*/gtf/<species>/\n"
        "  2. (optional) rRNA/Mt ROI BED and a mappability exclusion BED\n"
        "     (Mapability generate/collect around your aligner)\n"
        "  3. python -m irfinder_tpu_torch.cli BuildRef -g ann.gtf -r REF \\\n"
        "        [--roi roi.bed] [--exclude exclude.bed]\n"
        "Validate pre-fetched inputs with:  BuildRefDownload --manifest m.json\n"
        '  manifest JSON: {"gtf": "path", "fasta": "path", "roi": "path",\n'
        '                  "exclude": "path"}  (gtf required, rest optional)\n'
    )
    return 2


def _validate_manifest(path: str) -> int:
    """Check each manifest input exists and parses (first records)."""
    import gzip

    from .refio.gtf import iter_exons

    with open(path) as fh:
        man = json.load(fh)
    problems = []

    def opener(p):
        return gzip.open(p, "rt") if p.endswith(".gz") else open(p)

    if "gtf" not in man:
        problems.append("manifest: required key 'gtf' missing")
    for key in ("gtf", "fasta", "roi", "exclude"):
        p = man.get(key)
        if p is None:
            continue
        if not os.path.exists(p):
            problems.append(f"{key}: {p} does not exist")
            continue
        try:
            with opener(p) as fh:
                if key == "gtf":
                    n = sum(1 for _ in zip(range(50), iter_exons(p)))
                    if n == 0:
                        problems.append(f"gtf: {p} yields no exon records")
                elif key == "fasta":
                    first = fh.readline()
                    if not first.startswith(">"):
                        problems.append(f"fasta: {p} does not start with '>'")
                else:  # BED
                    rows = _parse_bed(p)
                    if not rows:
                        problems.append(f"{key}: {p} has no BED rows")
        except Exception as e:  # any unreadable input is reported, not raised
            problems.append(f"{key}: {p} unreadable/corrupt ({e})")
    for msg in problems:
        sys.stderr.write(f"BuildRefDownload: INVALID — {msg}\n")
    if not problems:
        print(f"BuildRefDownload: manifest {path} validated OK")
    return 1 if problems else 0


def cmd_export_glm(args) -> int:
    """DESeq2 GLM export (glm.py): the introns x (2*samples)
    intronic/spliced count matrix + coldata consumed by
    DESeqDataSetFromMatrix (docs/GLM_DIFFERENTIAL.md)."""
    from .glm import export_glm

    conditions = args.conditions.split(",") if args.conditions else None
    counts, coldata = export_glm(
        args.samples, args.out, conditions=conditions, mode="dir" if args.dir else "nondir",
    )
    print(f"ExportGLM: {counts} + {coldata}")
    return 0


def cmd_diff(args) -> int:
    from .diff import run_differential

    return run_differential(cond_a=args.a, cond_b=args.b, out_path=args.out, min_cov=args.min_cov)


def cmd_goldens(args) -> int:
    from .goldens import check

    return 1 if check(args.ours, args.golden, record=args.record) else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="irfinder-tpu-torch", description=__doc__)
    sub = p.add_subparsers(dest="mode", required=True)
    # BuildRefProcess and BuildRefFromSTARRef keep the reference's mode names:
    # the first was the processing half of its BuildRef, the second reused a
    # STAR index; alignment is external here, so both compile the GTF
    for mode, help_ in (
        ("BuildRef", "compile GTF -> reference tensors"),
        ("BuildRefProcess", "alias of BuildRef (BuildRefProcess parity)"),
        ("BuildRefFromSTARRef", "alias of BuildRef (BuildRefFromSTARRef parity)"),
    ):
        b = sub.add_parser(mode, help=help_)
        b.add_argument("-g", "--gtf", required=True, help="GTF annotation (.gtf or .gtf.gz)")
        b.add_argument("-r", "--ref", required=True, help="output reference directory")
        b.add_argument("--roi", help="BED of regions of interest (rRNA/Mt/ERCC)")
        b.add_argument("--exclude", help="BED of extra exclusion zones (low mappability)")
        b.set_defaults(fn=cmd_buildref)

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

    m = sub.add_parser("Mapability", help="mappability exclusion generation")
    m.add_argument("action", choices=["generate", "collect"])
    m.add_argument("-f", "--fasta", required=True, help="genome FASTA (.fa or .fa.gz)")
    m.add_argument("-b", "--bam", help="aligned tile-read BAM (collect)")
    m.add_argument("-o", "--out", required=True, help="output FASTQ (generate) / BED (collect)")
    m.add_argument("--read-len", type=int, default=None)
    m.add_argument("--stride", type=int, default=None)
    m.set_defaults(fn=cmd_mapability)

    dl = sub.add_parser("BuildRefDownload", help="(no network) document / validate inputs")
    dl.add_argument(
        "--manifest",
        help="JSON manifest of pre-fetched inputs to validate "
        '({"gtf": ..., "fasta": ..., "roi": ..., "exclude": ...})',
    )
    dl.set_defaults(fn=cmd_buildref_download)

    x = sub.add_parser("ExportGLM", help="export DESeq2 GLM count matrix + coldata")
    x.add_argument("-d", "--out", required=True, help="output directory")
    x.add_argument("samples", nargs="+", help="sample result dirs (from BAM/Batch)")
    x.add_argument(
        "--conditions",
        help="comma-separated condition labels, one per sample (default all A)",
    )
    x.add_argument(
        "--dir", action="store_true",
        help="export from the directional tables instead of nondir",
    )
    x.set_defaults(fn=cmd_export_glm)

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

    d = sub.add_parser("Diff", help="pooled small-replicate differential IR")
    d.add_argument("-a", nargs="+", required=True, help="condition A result dirs")
    d.add_argument("-b", nargs="+", required=True, help="condition B result dirs")
    d.add_argument("-d", "--out", required=True, help="output differential table path")
    d.add_argument("--min-cov", type=float, default=None, help="min intron depth filter")
    d.set_defaults(fn=cmd_diff)

    go = sub.add_parser(
        "Goldens",
        help="byte-compare a result dir against reference golden outputs; "
        "mismatches are localized to (table, line, column) and mapped to the "
        "semantics constants to re-derive (docs/GOLDEN_PINNING.md)",
    )
    go.add_argument("ours", help="our output directory (from BAM mode)")
    go.add_argument("golden", help="reference golden output directory")
    go.add_argument("--record", help="write a JSON pinning record (verdicts + live overrides)")
    go.set_defaults(fn=cmd_goldens)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
