"""Every CLI mode of the port against the JAX package's, on the same inputs.

Each mode runs through both ``irfinder_tpu.cli.main`` and
``irfinder_tpu_torch.cli.main`` on inputs made from a seed with numpy.  The
tolerance is zero: output files are byte-identical (a saved reference's
``ref.npz`` is compared by its fields, since zip entries carry timestamps),
printed lines are equal once the output path is the same, and exit codes
are equal.

* BuildRef (plain and gzipped GTF, --roi/--exclude) and its two aliases;
* Diff, with and without --min-cov, and against Batch's own differential;
* ExportGLM (nondir, --dir, --conditions) and its "intron rows differ" error;
* Goldens (match, mismatch, row count, missing table), with --record, and
  the golden-pinning rehearsal of test_golden_pinning_e2e.py through the
  port's BAM mode (--device cpu) under IRTPU_SEMANTICS;
* Mapability generate and collect;
* BuildRefDownload, without a manifest and with a valid, a missing and a
  corrupt-gzip one;
* the parser: the same modes and option strings, plus --device on the
  counting modes only;
* the host modes, run in a fresh interpreter with no card visible, never
  import torch nor initialise its CUDA state.
"""

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from irfinder_tpu import cli as jcli
from irfinder_tpu import goldens as jgoldens
from irfinder_tpu.refio.compile import CompiledRef as JCompiledRef
from irfinder_tpu_torch import cli, goldens
from irfinder_tpu_torch.conformance import write_realistic_bam
from irfinder_tpu_torch.io import bamwrite
from irfinder_tpu_torch.refio.compile import CompiledRef, compile_reference
from irfinder_tpu_torch.refio.mapgen import iter_tiles
from irfinder_tpu_torch.synth import synth_exons

from test_oracle import CHROMS, ROIS, random_bam_bytes, toy_exons
from test_torch_parity import assert_same_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SAMPLES = 4


def write_gtf(path: str, exons, seed: int = 0) -> None:
    """A GTF of ``exons`` (0-based half-open -> 1-based inclusive), with a
    header comment, gene and transcript lines the parser skips, and a
    gene_name attribute on a seeded half of the genes."""
    rng = np.random.default_rng(seed)
    named = {}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as fh:
        fh.write("#!genome-build synthetic\n")
        seen = set()
        for e in exons:
            if e.gene_id not in named:
                named[e.gene_id] = bool(rng.integers(0, 2))
            attrs = f'gene_id "{e.gene_id}"; transcript_id "{e.transcript_id}";'
            if named[e.gene_id]:
                attrs += f' gene_name "N{e.gene_id}";'
            if e.transcript_id not in seen:
                seen.add(e.transcript_id)
                fh.write(f"{e.chrom}\tsynth\ttranscript\t{e.start + 1}\t{e.end}\t.\t{e.strand}\t.\t{attrs}\n")
            fh.write(f"{e.chrom}\tsynth\texon\t{e.start + 1}\t{e.end}\t.\t{e.strand}\t.\t{attrs}\n")


def write_bed(path: str, rows) -> None:
    with open(path, "w") as fh:
        fh.write("track name=synthetic\n")
        for r in rows:
            fh.write("\t".join(str(x) for x in r) + "\n")


def both(argv_of, capsys, tmp_path):
    """Run one mode through both CLIs; ``argv_of(side)`` builds the argv
    for a side ('jax' or 'port', which name its output paths).  Returns
    {side: (rc, stdout, stderr)} with each side's name replaced by SIDE."""
    res = {}
    for side, main in (("jax", jcli.main), ("port", cli.main)):
        rc = main(argv_of(side))
        out = capsys.readouterr()
        res[side] = tuple(
            [rc] + [t.replace(str(tmp_path / side), "SIDE") for t in (out.out, out.err)]
        )
    return res


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A seeded two-chrom annotation as a GTF (plain and gzipped), ROI and
    exclusion BEDs, and a reference built from them by the port's BuildRef."""
    d = tmp_path_factory.mktemp("cli_inputs")
    exons = synth_exons(n_genes=30, n_chroms=2, chrom_len=1_200_000, seed=3)
    gtf, gtf_gz = str(d / "ann.gtf"), str(d / "ann.gtf.gz")
    write_gtf(gtf, exons)
    write_gtf(gtf_gz, exons)
    roi, excl = str(d / "roi.bed"), str(d / "excl.bed")
    write_bed(roi, [("chr21.0", 0, 40_000, "rRNA-like", 0, "+"), ("chr21.1", 1000, 9000, "Mt-like", 0, ".")])
    rng = np.random.default_rng(4)
    starts = np.sort(rng.integers(0, 1_000_000, 6))
    write_bed(excl, [(f"chr21.{i % 2}", int(s), int(s) + 5000) for i, s in enumerate(starts)])
    return {"dir": d, "gtf": gtf, "gtf_gz": gtf_gz, "roi": roi, "exclude": excl}


@pytest.fixture(scope="module")
def samples(inputs):
    """N_SAMPLES result directories counted on the CPU by the port's Batch
    mode off its BuildRef output, with Batch's differential of 2 vs 2."""
    d = inputs["dir"]
    ref_dir = str(d / "REF")
    assert cli.main(["BuildRef", "-g", inputs["gtf"], "-r", ref_dir, "--roi", inputs["roi"]]) == 0
    ref = CompiledRef.load(ref_dir)
    bams = []
    for i in range(N_SAMPLES):
        bams.append(str(d / f"s{i}.bam"))
        write_realistic_bam(bams[-1], ref, n_pairs=2500, seed=40 + i)
    out = str(d / "batch")
    assert cli.main(["Batch", "-r", ref_dir, "-d", out, *bams, "--a", "0,1", "--b", "2,3",
                     "--device", "cpu"]) == 0
    dirs = [os.path.join(out, f"s{i}") for i in range(N_SAMPLES)]
    return {"ref": ref_dir, "bams": bams, "dirs": dirs, "root": str(d),
            "diff": os.path.join(out, "IRFinder-Diff.txt")}


def read(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


@pytest.mark.parametrize("mode,gtf,beds", [
    ("BuildRef", "gtf", ()),
    ("BuildRef", "gtf_gz", ()),
    ("BuildRef", "gtf", ("roi", "exclude")),
    ("BuildRefProcess", "gtf_gz", ("roi",)),
    ("BuildRefFromSTARRef", "gtf", ("exclude",)),
])
def test_buildref_matches_jax(mode, gtf, beds, inputs, capsys, tmp_path):
    def argv(side):
        out = ["-r", str(tmp_path / side / "REF")]
        return [mode, "-g", inputs[gtf], *out, *(a for b in beds for a in (f"--{b}", inputs[b]))]

    res = both(argv, capsys, tmp_path)
    assert res["jax"] == res["port"] and res["port"][0] == 0
    assert res["port"][1].startswith("BuildRef: ") and res["port"][1].endswith("-> SIDE/REF\n")
    jd, pd = str(tmp_path / "jax" / "REF"), str(tmp_path / "port" / "REF")
    assert read(os.path.join(jd, "ref.json")) == read(os.path.join(pd, "ref.json"))
    with np.load(os.path.join(jd, "ref.npz")) as a, np.load(os.path.join(pd, "ref.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # each package loads the other's reference, field for field
    assert_same_ref(CompiledRef.load(jd), JCompiledRef.load(pd))
    assert_same_ref(JCompiledRef.load(jd), CompiledRef.load(pd))
    ref = CompiledRef.load(pd)
    assert ref.n_introns > 100 and ref.n_chroms == 2
    assert len(ref.roi_names) == (2 if "roi" in beds else 0)


@pytest.mark.parametrize("min_cov", [None, "3"])
def test_diff_matches_jax(min_cov, samples, capsys, tmp_path):
    dirs = samples["dirs"]
    extra = ["--min-cov", min_cov] if min_cov else []

    def argv(side):
        os.makedirs(tmp_path / side, exist_ok=True)
        return ["Diff", "-a", *dirs[:2], "-b", *dirs[2:], "-d", str(tmp_path / side / "diff.txt"), *extra]

    res = both(argv, capsys, tmp_path)
    assert res["jax"] == res["port"] and res["port"][0] == 0
    got = read(str(tmp_path / "port" / "diff.txt"))
    assert got == read(str(tmp_path / "jax" / "diff.txt"))
    assert got.count(b"\n") > 10
    if min_cov is None:
        # Batch --a/--b wrote the same differential
        assert got == read(samples["diff"])


@pytest.mark.parametrize("flags", [[], ["--dir"], ["--conditions", "A,A,B,B"]])
def test_export_glm_matches_jax(flags, samples, capsys, tmp_path):
    res = both(lambda side: ["ExportGLM", "-d", str(tmp_path / side), *samples["dirs"], *flags],
               capsys, tmp_path)
    assert res["jax"] == res["port"] and res["port"][0] == 0
    for name in ("GLM-counts.tsv", "GLM-coldata.tsv"):
        got = read(str(tmp_path / "port" / name))
        assert got == read(str(tmp_path / "jax" / name)), name
    with open(tmp_path / "port" / "GLM-coldata.tsv") as fh:
        assert len(fh.read().splitlines()) == 1 + 2 * N_SAMPLES


def test_export_glm_rejects_differing_rows_like_jax(samples, tmp_path):
    """A sample whose intron rows differ: both packages raise the same
    error."""
    odd = str(tmp_path / "odd")
    shutil.copytree(samples["dirs"][1], odd)
    for mode in ("nondir", "dir"):
        path = os.path.join(odd, f"IRFinder-IR-{mode}.txt")
        with open(path) as fh:
            lines = fh.readlines()
        with open(path, "w") as fh:
            fh.writelines(lines[:3] + lines[4:])
    errs = []
    for main in (jcli.main, cli.main):
        with pytest.raises(ValueError, match="intron rows differ") as e:
            main(["ExportGLM", "-d", str(tmp_path / "glm"), samples["dirs"][0], odd])
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def _tamper(src: str, dst: str, case: str) -> None:
    shutil.copytree(src, dst)
    if case == "mismatch":
        path = os.path.join(dst, "IRFinder-IR-nondir.txt")
        with open(path) as fh:
            lines = fh.readlines()
        header = lines[0].rstrip("\n").split("\t")
        f = lines[5].rstrip("\n").split("\t")
        j = header.index("IntronDepth")
        f[j] = str(float(f[j]) + 1.5)
        lines[5] = "\t".join(f) + "\n"
        with open(path, "w") as fh:
            fh.writelines(lines)
    elif case == "rows":
        path = os.path.join(dst, "IRFinder-IR-dir.txt")
        with open(path) as fh:
            lines = fh.readlines()
        with open(path, "w") as fh:
            fh.writelines(lines[:-1])
    elif case == "missing":
        os.remove(os.path.join(dst, "IRFinder-ROI.txt"))


@pytest.mark.parametrize("case,rc", [("match", 0), ("mismatch", 1), ("rows", 1), ("missing", 1)])
def test_goldens_matches_jax(case, rc, samples, capsys, tmp_path):
    golden = samples["dirs"][0]
    ours = str(tmp_path / "ours")
    _tamper(golden, ours, case)
    res = both(lambda side: ["Goldens", ours, golden, "--record", str(tmp_path / f"{side}.json")],
               capsys, tmp_path)
    assert res["jax"] == res["port"] and res["port"][0] == rc
    if case == "mismatch":
        assert "IntronDepth" in res["port"][1] and "MIN_MAPQ" in res["port"][1]
    recs = []
    for side in ("jax", "port"):
        with open(tmp_path / f"{side}.json") as fh:
            rec = json.load(fh)
        for k in ("when", "ours", "golden"):
            rec.pop(k)
        recs.append(rec)
    assert recs[0] == recs[1] and recs[1]["pinned"] is (rc == 0)
    # the module's own entry point
    assert goldens.main([ours, golden]) == jgoldens.main([ours, golden]) == rc
    assert goldens.main([ours]) == 2
    capsys.readouterr()


def _env(overrides=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("IRTPU_SEMANTICS", None)
    if overrides:
        env["IRTPU_SEMANTICS"] = json.dumps(overrides)
    return env


def test_golden_pinning_flow_through_the_port(tmp_path):
    """test_golden_pinning_e2e.py's rehearsal with the port: a run under
    SPANS_OVERHANG=5 stands in for a foreign golden; the port's Goldens names
    SPANS_OVERHANG, the override rematches byte for byte, and --record
    carries it."""
    ref = compile_reference(toy_exons(), chrom_order=CHROMS, rois=ROIS)
    ref_dir = str(tmp_path / "REF")
    ref.save(ref_dir)
    bam = str(tmp_path / "in.bam")
    with open(bam, "wb") as fh:
        fh.write(random_bam_bytes(seed=17, n_frags=500))

    def port(argv, overrides):
        return subprocess.run([sys.executable, "-m", "irfinder_tpu_torch.cli", *argv], cwd=ROOT,
                              env=_env(overrides), capture_output=True, text=True, timeout=300)

    runs = {"golden": {"SPANS_OVERHANG": 5}, "ours": None, "pinned": {"SPANS_OVERHANG": 5}}
    for name, ov in runs.items():
        r = port(["BAM", "-r", ref_dir, "-d", str(tmp_path / name), "--no-native", bam, "--device", "cpu"], ov)
        assert r.returncode == 0, r.stderr[-2000:]
    golden, ours, pinned = (str(tmp_path / k) for k in runs)
    r = goldens.compare_table(os.path.join(ours, "IRFinder-IR-nondir.txt"),
                              os.path.join(golden, "IRFinder-IR-nondir.txt"))
    assert not r["match"] and r["column"].startswith("ExonToIntronReads"), r
    assert "SPANS_OVERHANG" in r["suspect_constants"], r
    assert goldens.check(pinned, golden) == 0

    record = str(tmp_path / "pinning.json")
    r2 = port(["Goldens", pinned, golden, "--record", record], {"SPANS_OVERHANG": 5})
    assert r2.returncode == 0, r2.stdout + r2.stderr
    with open(record) as fh:
        rec = json.load(fh)
    assert rec["pinned"] is True and rec["semantics_overrides"] == {"SPANS_OVERHANG": 5}
    assert all(t["match"] for t in rec["tables"])
    r3 = port(["Goldens", ours, golden], None)
    assert r3.returncode == 1
    assert "MISMATCH" in r3.stdout and "SPANS_OVERHANG" in r3.stdout


def write_fasta(path: str, seed: int = 0) -> dict:
    """Two seeded chromosomes: chrA with a planted 600-base duplicate (at
    3,000 and 11,000) and a 300-base run of Ns at 7,000; chrB plain.
    Returns the planted intervals."""
    rng = np.random.default_rng(seed)
    a = bytearray(rng.choice(list(b"ACGT"), 16_000).tobytes())
    a[11_000:11_600] = a[3_000:3_600]
    a[7_000:7_300] = b"N" * 300
    b = rng.choice(list(b"acgt"), 5_003).tobytes()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as fh:
        for name, seq in (("chrA", bytes(a)), ("chrB", b)):
            fh.write(f">{name} synthetic\n")
            for i in range(0, len(seq), 60):
                fh.write(seq[i:i + 60].decode() + "\n")
    return {"dups": [(3_000, 3_600), (11_000, 11_600)], "n_run": (7_000, 7_300)}


@pytest.mark.parametrize("fasta,flags", [("g.fa", []), ("g.fa.gz", ["--read-len", "30", "--stride", "7"])])
def test_mapability_matches_jax(fasta, flags, capsys, tmp_path):
    from irfinder_tpu_torch.refio.mapgen import read_fasta

    fa = str(tmp_path / fasta)
    planted = write_fasta(fa)
    res = both(lambda side: ["Mapability", "generate", "-f", fa, "-o", str(tmp_path / f"{side}.fq"), *flags],
               capsys, tmp_path)
    assert res["jax"][0] == res["port"][0] == 0
    assert res["jax"][1].replace("jax.fq", "X") == res["port"][1].replace("port.fq", "X")
    fq = read(str(tmp_path / "port.fq"))
    assert fq == read(str(tmp_path / "jax.fq")) and fq.startswith(b"@mapgen|chrA|0\n")

    # the stand-in aligner: every tile back at its origin, MAPQ 0 where it
    # touches either copy of the duplicate
    read_len = int(flags[1]) if flags else 70
    stride = int(flags[3]) if flags else 10
    seqs = read_fasta(fa)
    names = list(seqs)
    records = []
    for i, (c, pos, _) in enumerate(iter_tiles(seqs, read_len, stride)):
        dup = any(pos < e and s < pos + read_len for s, e in planted["dups"]) and c == "chrA"
        records.append(bamwrite.make_single(f"t{i}", names.index(c), pos, f"{read_len}M", mapq=0 if dup else 60))
    bam = str(tmp_path / "tiles.bam")
    with open(bam, "wb") as fh:
        bamwrite.write_bam(fh, names, [len(seqs[c]) for c in names], records)
    res = both(lambda side: ["Mapability", "collect", "-f", fa, "-b", bam, "-o", str(tmp_path / f"{side}.bed"),
                             *flags], capsys, tmp_path)
    assert res["jax"][0] == res["port"][0] == 0
    assert res["jax"][1].replace("jax.bed", "X") == res["port"][1].replace("port.bed", "X")
    bed = read(str(tmp_path / "port.bed"))
    assert bed == read(str(tmp_path / "jax.bed"))
    rows = [ln.split("\t") for ln in bed.decode().splitlines()]
    for lo, hi in [*planted["dups"], planted["n_run"]]:
        assert any(r[0] == "chrA" and int(r[1]) <= lo and hi <= int(r[2]) for r in rows), (lo, hi)
    assert all(r[0] == "chrA" for r in rows), rows


@pytest.mark.parametrize("case,rc", [("none", 2), ("valid", 0), ("missing", 1), ("corrupt", 1)])
def test_buildref_download_matches_jax(case, rc, inputs, capsys, tmp_path):
    fa = str(tmp_path / "g.fa")
    write_fasta(fa)
    man = str(tmp_path / "m.json")
    spec = {"gtf": inputs["gtf_gz"], "fasta": fa, "roi": inputs["roi"], "exclude": inputs["exclude"]}
    if case == "missing":
        spec["fasta"] = str(tmp_path / "absent.fa")
    elif case == "corrupt":
        spec["gtf"] = str(tmp_path / "broken.gtf.gz")
        with open(spec["gtf"], "wb") as fh:
            fh.write(b"this is not gzip data\n" * 4)
    with open(man, "w") as fh:
        json.dump(spec, fh)
    argv = ["BuildRefDownload"] + ([] if case == "none" else ["--manifest", man])
    res = both(lambda side: argv, capsys, tmp_path)
    jrc, jout, jerr = res["jax"]
    prc, pout, perr = res["port"]
    assert jrc == prc == rc and jout == pout
    assert perr.replace("irfinder_tpu_torch.cli", "irfinder_tpu.cli") == jerr
    if case == "none":
        assert "python -m irfinder_tpu_torch.cli BuildRef" in perr
    elif case == "valid":
        assert "validated OK" in pout and not perr
    else:
        assert "INVALID" in perr


def _modes(parser) -> dict:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {o for a in p._actions for o in a.option_strings} for name, p in sub.choices.items()}


def test_parser_has_the_reference_modes_and_flags():
    want, got = _modes(jcli.build_parser()), _modes(cli.build_parser())
    assert set(got) == set(want) and len(got) == 11
    for mode in want:
        extra = {"--device"} if mode in ("BAM", "Batch", "FastQ") else set()
        assert got[mode] == want[mode] | extra, mode
    assert not hasattr(cli, "NOT_PORTED") and not hasattr(cli, "_not_ported")


HOST_MODES = r"""
import contextlib, io, json, os, sys
from irfinder_tpu_torch import cli
d, gtf, roi, fa, bam = sys.argv[1:6]
dirs = sys.argv[6:]


def modes(tag):
    out = os.path.join(d, tag)
    with contextlib.redirect_stdout(io.StringIO()):
        for argv in (
            ["BuildRef", "-g", gtf, "-r", os.path.join(out, "REF"), "--roi", roi],
            ["BuildRefProcess", "-g", gtf, "-r", os.path.join(out, "REF2")],
            ["Mapability", "generate", "-f", fa, "-o", os.path.join(out, "t.fq")],
            ["Mapability", "collect", "-f", fa, "-b", bam, "-o", os.path.join(out, "x.bed")],
            ["ExportGLM", "-d", os.path.join(out, "glm"), *dirs],
            ["Diff", "-a", *dirs[:2], "-b", *dirs[2:], "-d", os.path.join(out, "diff.txt")],
            ["Goldens", dirs[0], dirs[0]],
        ):
            os.makedirs(out, exist_ok=True)
            assert cli.main(argv) == 0, argv
        with open(os.path.join(out, "m.json"), "w") as fh:
            json.dump({"gtf": gtf, "fasta": fa, "roi": roi}, fh)
        assert cli.main(["BuildRefDownload", "--manifest", os.path.join(out, "m.json")]) == 0


modes("bare")
assert "torch" not in sys.modules, "a host mode imported torch"
import torch
modes("torch")
assert not torch.cuda.is_initialized()
print("HOST_MODES_OK")
"""


def test_host_modes_leave_the_card_alone(inputs, samples, tmp_path):
    """BuildRef, its alias, Mapability, ExportGLM, Diff, Goldens and
    BuildRefDownload run in a fresh interpreter with no card visible: they
    import no torch, and with torch imported they leave its CUDA state
    uninitialised."""
    fa = str(tmp_path / "g.fa")
    write_fasta(fa)
    from irfinder_tpu_torch.refio.mapgen import read_fasta

    seqs = read_fasta(fa)
    bam = str(tmp_path / "tiles.bam")
    with open(bam, "wb") as fh:
        recs = [bamwrite.make_single(f"t{i}", list(seqs).index(c), p, "70M", mapq=60)
                for i, (c, p, _) in enumerate(iter_tiles(seqs))]
        bamwrite.write_bam(fh, list(seqs), [len(s) for s in seqs.values()], recs)
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run(
        [sys.executable, "-c", HOST_MODES, str(tmp_path), inputs["gtf"], inputs["roi"], fa, bam,
         *samples["dirs"]],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "HOST_MODES_OK" in r.stdout
    for name in ("REF/ref.json", "glm/GLM-counts.tsv", "diff.txt", "x.bed"):
        assert read(str(tmp_path / "bare" / name)) == read(str(tmp_path / "torch" / name)), name


def test_port_goldens_module_runs_as_a_script(samples):
    d = samples["dirs"][0]
    r = subprocess.run([sys.executable, "-m", "irfinder_tpu_torch.goldens", d, d], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("MATCH (byte-identical)") == 6


def test_exons_fields_survive_the_gtf(inputs):
    """The GTF writer above round-trips through the port's parser: what
    BuildRef compiles is the seeded annotation."""
    from irfinder_tpu_torch.refio.gtf import iter_exons

    want = synth_exons(n_genes=30, n_chroms=2, chrom_len=1_200_000, seed=3)
    for path in (inputs["gtf"], inputs["gtf_gz"]):
        got = list(iter_exons(path))
        assert [(e.chrom, e.start, e.end, e.strand, e.gene_id, e.transcript_id) for e in got] == [
            (e.chrom, e.start, e.end, e.strand, e.gene_id, e.transcript_id) for e in want]
        named = [e.gene_name != e.gene_id for e in got]
        assert any(named) and not all(named)
