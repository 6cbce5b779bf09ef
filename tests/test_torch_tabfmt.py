"""The port's table formatter (irfinder_tpu_torch/native/tabfmt) on the CPU.

A table of more than ROWS_PER_CHUNK rows renders in row chunks, one thread
each; its bytes must be those of format.py's per-line Python writers (the
formatting spec) for every row count around the chunk boundaries, every
column kind and the %g edge values, in one chunk and in several.  An IR
table reads its map's intron-name pool, made once per map
(finalize.intron_name_pool); two maps rendered in turn each write their
own names.  A pool, and a map's finalize tables (build_finalize_ref), are
made anew only when a field they are made from is replaced.  write_table
counts the bytes it writes and times each table in its span.
"""

import dataclasses
import io
import json
import math
import os
import types

import numpy as np
import pytest

from irfinder_tpu_torch import format as fmt
from irfinder_tpu_torch import semantics as S
from irfinder_tpu_torch.conformance import synth_ref, write_realistic_bam
from irfinder_tpu_torch.engine import RunMetrics, run_bam, write_table
from irfinder_tpu_torch.finalize import IRTable, intron_name_pool
from irfinder_tpu_torch.native import tabfmt
from irfinder_tpu_torch.ops.finalize_stats import build_finalize_ref

pytestmark = pytest.mark.skipif(not tabfmt.available(), reason="native toolchain unavailable")

R = tabfmt.ROWS_PER_CHUNK
#: the whole-genome map's introns (portbench's grch38 configuration)
GENOME_INTRONS = 174_940
#: %g edge values: signed zeros, the exponent switch around 1e-4 and 1e6,
#: rounding ties, large values, subnormals, infinities and nan
G_EDGES = (0.0, -0.0, 1e-5, 9.999995e-5, 1e-4, 0.1, 123456.5, 999999.5, 1e16,
           5e-324, -5e-324, 2.2250738585072014e-308 / 3, math.inf, -math.inf, math.nan)
I_EDGES = (0, -1, 1, 2**63 - 1, -(2**63))


def _spread(col: np.ndarray, edges, rng) -> np.ndarray:
    """``col`` with ``edges`` at the first and last rows and at random rows
    between (so every chunk holds some)."""
    n = col.size
    if n:
        at = np.concatenate([np.arange(min(n, len(edges))), np.arange(max(0, n - len(edges)), n),
                             rng.integers(0, n, 4 * len(edges))])
        col[at] = np.resize(np.asarray(edges, col.dtype), at.size)
    return col


def _names(n: int, rng) -> list:
    """Intron names shaped as a whole genome's: GeneSymbol/GeneID/class."""
    sym = rng.integers(3, 16, n)
    cls = rng.integers(0, len(S.INTRON_CLASSES), n)
    return [f"{'G' * int(k)}{i}/ENSG{i:011d}/{S.INTRON_CLASSES[c]}"
            for i, (k, c) in enumerate(zip(sym.tolist(), cls.tolist()))]


def _map(n: int, seed: int = 0, names: list | None = None):
    """The parts of a map an IR table reads, for ``n`` introns."""
    rng = np.random.default_rng(seed)
    chroms = [f"chr{i}" for i in range(1, 23)] + ["chrX", "chrY"]
    return types.SimpleNamespace(
        chroms=chroms,
        intron_chrom=np.sort(rng.integers(0, len(chroms), n)).astype(np.int32),
        intron_start=rng.integers(0, 2**28, n).astype(np.int32),
        intron_end=rng.integers(0, 2**28, n).astype(np.int32),
        intron_names=_names(n, rng) if names is None else names,
        n_introns=n,
    )


def _ir_table(ref, seed: int = 1) -> IRTable:
    """An IR table of random statistics with every edge value.  The mean
    depth takes no nan: the finalize never makes one (an intron without
    measured bases has mean 0), and there the spec's scalar IRratio (nan)
    and the tables' vectorized one (0) part."""
    rng = np.random.default_rng(seed)
    n = ref.n_introns

    def g(edges=G_EDGES):
        return _spread(rng.random(n) * 60, edges, rng)

    def i(hi=500, edges=None):
        col = rng.integers(0, hi, n).astype(np.int64)
        return col if edges is None else _spread(col, edges, rng)

    a = {
        "istrand": rng.integers(0, 3, n).astype(np.int64),
        "cov": g(), "mean": g(G_EDGES[:-1]), "firstw": g(), "lastw": g(),
        "p25": i(), "p50": i(edges=I_EDGES), "p75": i(),
        "eil": i(edges=I_EDGES), "eir": i(edges=I_EDGES), "sl": i(), "sr": i(), "sx": i(),
    }
    return IRTable(ref, a)


def _junc_tally(n: int, seed: int = 2) -> dict:
    """``n`` distinct junctions (in no order) with random counts."""
    rng = np.random.default_rng(seed)
    m = n + n // 8 + 16
    keys = np.stack([rng.integers(0, 24, m), rng.integers(0, 2**28, m), rng.integers(0, 2**28, m)], 1)
    first = np.sort(np.unique(keys, axis=0, return_index=True)[1])[:n]
    assert len(first) == n
    keys = keys[first].tolist()
    vals = rng.integers(0, 900, (n, 2)).tolist()
    return dict(zip(map(tuple, keys), vals))


#: case -> (ROWS_PER_CHUNK, usable cores, rows); the whole-genome case takes
#: 2 cores so that it splits on any machine and loads a shared one little
CASES = {
    **{f"rows{n}": (R, 8, n) for n in (0, 1, R - 1, R, R + 1, 3 * R + 7)},
    "genome": (R, 2, GENOME_INTRONS),
    **{f"forced{n}": (4, 8, n) for n in (0, 1, 3, 4, 5, 19)},
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_render_matches_spec(case, monkeypatch):
    """The IR and JuncCount tables, rendered natively in as many chunks as
    the row count and the cores ask for, are the Python writers' bytes;
    forced cases lower ROWS_PER_CHUNK to 4 so small tables split.  The
    JuncCount table stops at 3R + 7 junctions, the largest rows case."""
    rows_per_chunk, cores, n = CASES[case]
    monkeypatch.setattr(tabfmt, "ROWS_PER_CHUNK", rows_per_chunk)
    monkeypatch.setattr(tabfmt, "usable_cores", lambda: cores)
    k = tabfmt.chunk_count(n)
    assert k == max(1, min(cores, -(-n // rows_per_chunk)))
    assert (k > 1) == (n > rows_per_chunk)

    ref = _map(n)
    table = _ir_table(ref)
    tally = _junc_tally(min(n, 3 * R + 7))
    native, spec = io.StringIO(), io.StringIO()
    fmt.write_ir_table(native, table)
    fmt.write_junc_count(native, ref.chroms, dict(tally))
    fmt.write_ir_table(spec, table.rows())
    monkeypatch.setattr(fmt, "_native_render", lambda cols: None)
    fmt.write_junc_count(spec, ref.chroms, dict(tally))
    assert native.getvalue() == spec.getvalue()
    assert native.getvalue().count("\n") == n + len(tally) + 2


@pytest.mark.parametrize("chunks", ["one", "several"])
@pytest.mark.parametrize("bad", [-1, 3])
def test_out_of_range_pool_index_in_the_last_chunk_raises(chunks, bad, monkeypatch):
    if chunks == "several":
        monkeypatch.setattr(tabfmt, "ROWS_PER_CHUNK", 16)
        monkeypatch.setattr(tabfmt, "usable_cores", lambda: 8)
    n = 200
    idx = np.zeros(n, np.int32)
    idx[-1] = bad
    cols = [("i", np.arange(n)), ("s", idx, ["a", "b", "c"]), ("g", np.ones(n))]
    assert tabfmt.chunk_count(n) == (1 if chunks == "one" else 8)
    with pytest.raises(RuntimeError, match="pool index"):
        tabfmt.format_table(cols)
    idx[-1] = 2
    assert tabfmt.format_table(cols).decode().endswith(f"{n - 1}\tc\t1\n")


def _finalize_ref_rebuilt_on_a_new_run_len():
    """A map's finalize tables are made once per device, kept when a field
    they are not made from is replaced, and made anew, from the new field,
    when ``run_len`` is."""
    ref = synth_ref(n_genes=8, chrom_len=1_000_000)
    fr = build_finalize_ref(ref, "cpu")
    assert build_finalize_ref(ref, "cpu") is fr
    ref.intron_names = [s.upper() for s in ref.intron_names]
    assert build_finalize_ref(ref, "cpu") is fr
    i = int(np.argmax(ref.run_len))
    ref.run_len = ref.run_len.copy()
    ref.run_len[i] -= 1
    again = build_finalize_ref(ref, "cpu")
    assert again is not fr and build_finalize_ref(ref, "cpu") is again
    assert again.n_bases.sum() == fr.n_bases.sum() - 1
    assert intron_name_pool(ref) is intron_name_pool(ref)


@pytest.mark.parametrize("value", ["name_pool", "finalize_ref"])
def test_name_pool_is_made_once_per_map(value, monkeypatch):
    """Repeated renders of one map reuse its pool and give the same bytes;
    two maps with other names, rendered in turn, each write their own; a
    map whose name list is replaced gets a pool made anew.  The map's
    finalize tables follow the same rule (_finalize_ref_rebuilt_on_a_new_run_len)."""
    if value == "finalize_ref":
        return _finalize_ref_rebuilt_on_a_new_run_len()
    monkeypatch.setattr(tabfmt, "ROWS_PER_CHUNK", 64)
    n = 1000
    a, b = _map(n, seed=0), _map(n, seed=0, names=[f"other/{i}/clean" for i in range(n)])
    ta, tb = _ir_table(a), _ir_table(b)

    def render(t):
        out = io.StringIO()
        fmt.write_ir_table(out, t)
        return out.getvalue()

    def names(text):
        return [line.split("\t")[3] for line in text.splitlines()[1:]]

    first = render(ta)
    pool = intron_name_pool(a)
    assert render(ta) == first and intron_name_pool(a) is pool
    other = render(tb)
    assert render(ta) == first
    assert names(first) == a.intron_names and names(other) == b.intron_names
    a.intron_names = [s.upper() for s in a.intron_names]
    assert intron_name_pool(a) is not pool
    assert names(render(ta)) == a.intron_names


@pytest.mark.parametrize("n,split", [(64, False), (65, True)])
def test_write_table_counts_chunks(n, split, monkeypatch, tmp_path):
    """write_table writes a table at ROWS_PER_CHUNK rows (one chunk) and one
    row past it (two) as the Python writer's bytes, counts them in
    table_bytes and times each table in its span write.<table>."""
    monkeypatch.setattr(tabfmt, "ROWS_PER_CHUNK", 64)
    monkeypatch.setattr(tabfmt, "usable_cores", lambda: 8)
    assert tabfmt.chunk_count(n) == (2 if split else 1)
    m = RunMetrics()
    table = _ir_table(_map(n))
    names = ("IRFinder-IR-nondir.txt", "IRFinder-IR-dir.txt")
    for name in names:
        write_table(str(tmp_path), name, m, lambda fh: fmt.write_ir_table(fh, table))
    spec = io.StringIO()
    fmt.write_ir_table(spec, table.rows())
    for name in names:
        with open(tmp_path / name) as fh:
            assert fh.read() == spec.getvalue(), name
    assert m.table_bytes == 2 * len(spec.getvalue().encode())
    assert m.spans["write.IR-nondir"] > 0 and m.spans["write.IR-dir"] > 0


@pytest.fixture(scope="module")
def small_run(tmp_path_factory):
    ref = synth_ref(n_genes=8, chrom_len=1_000_000)
    d = tmp_path_factory.mktemp("tabfmt")
    bam = str(d / "s.bam")
    write_realistic_bam(bam, ref, n_pairs=1500, seed=0)
    return ref, bam, d


@pytest.mark.parametrize("rows_per_chunk", [4, R])
def test_run_bam_metrics_count_split_tables(rows_per_chunk, small_run, monkeypatch):
    """run_bam with a chunk of 4 rows, where both IR tables, SpansPoint and
    JuncCount render in 8 chunks each, and at the default, where each
    renders in one: the tables are the same bytes either way, and
    metrics.json counts no renders or chunks."""
    ref, bam, d = small_run
    monkeypatch.setattr(tabfmt, "ROWS_PER_CHUNK", rows_per_chunk)
    monkeypatch.setattr(tabfmt, "usable_cores", lambda: 8)
    out = str(d / f"out{rows_per_chunk}")
    m = run_bam(ref, bam, out, cap_frags=256, device="cpu")
    with open(os.path.join(out, "metrics.json")) as fh:
        saved = json.load(fh)
    assert set(saved) == {f.name for f in dataclasses.fields(RunMetrics)}
    assert not [k for k in saved if k.startswith("write")]
    rows = [ref.n_introns, ref.n_introns, int(ref.point_coord.size), m.junctions_distinct]
    assert min(rows) > 4 * 8
    if rows_per_chunk == 4:
        assert [tabfmt.chunk_count(r) for r in rows] == [8] * 4
    else:
        assert max(rows) <= R
        assert [tabfmt.chunk_count(r) for r in rows] == [1] * 4
    other = str(d / f"out{R if rows_per_chunk == 4 else 4}")
    if os.path.isdir(other):
        for name in sorted(os.listdir(out)):
            if name != "metrics.json":
                with open(os.path.join(out, name), "rb") as x, open(os.path.join(other, name), "rb") as y:
                    assert x.read() == y.read(), name
