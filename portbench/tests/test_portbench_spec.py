"""BENCHMARK.json keeps to the benchmark's format and limits, and every cell finds
its files by name: a later change adds a cell, a configuration, a traffic
mix or a metric by adding files and entries only."""

import json
import math
import os
import re

import pytest

from portbench import harness as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(H.ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_and_units(bench):
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in bench[k]]
    assert all(NAME.match(n) for n in names), names
    for k in ("configs", "workloads"):
        assert len({e["name"] for e in bench[k]}) == len(bench[k])
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for e in bench["workloads"]:
        assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and _one_line(e["why"])
    for c in bench["configs"]:
        assert _one_line(c["source"]) and _one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(m["layer"])


def test_every_cell_reports(bench):
    """setup_s, another end-to-end metric and a per-layer metric in every
    cell; every per-layer metric moves an end-to-end metric its cells
    report; at most a quarter of the cells take four chips."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        got = [m["name"] for m in H._for_cell(bench["end_to_end"], w["name"])]
        assert "setup_s" in got and len(got) >= 2, w["name"]
        assert H._for_cell(bench["per_layer"], w["name"]), w["name"]
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", [x["name"] for x in bench["workloads"]]):
            assert w in moved.get("workloads", [w]), (m["name"], w)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_files_found_by_name(bench):
    """Each cell's configuration and traffic file and each metric's reader
    exist where the harness looks for them, each configuration is used,
    and every file lies under ``paths``."""
    used = set()
    for w in bench["workloads"]:
        spec = H.load_spec(w["name"])
        assert spec.traffic["samples_per_call"] >= 1
        assert "map" in spec.config and spec.config["reduced"] == \
            {c["name"]: c for c in bench["configs"]}[w["config"]]["reduced"]
        used.add(w["config"])
    assert used == {c["name"] for c in bench["configs"]}
    files = {c["file"] for c in bench["configs"]}
    assert len(files) == len(bench["configs"])
    assert all(f.startswith(tuple(p + "/" for p in bench["paths"])) for f in files)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(H.reader(m["name"])), m["name"]


def test_traffic_read_kinds(bench):
    """A traffic's ``reads`` names a module of reads/ that writes its BAMs
    and its warm-up; ``long_reads`` comes with one sample a call."""
    from portbench import inputs

    kinds = set()
    for w in bench["workloads"]:
        tr = H.load_spec(w["name"]).traffic
        if "reads" in tr:
            mod = inputs.read_kind(tr["reads"])
            assert callable(mod.write_bam) and set(mod.WARMUP) <= set(tr), w["name"]
            kinds.add(tr["reads"])
        if tr.get("long_reads"):
            assert tr["samples_per_call"] == 1, w["name"]
    assert "longread" in kinds
    spec = H.load_spec("chr21.longread")
    assert spec.traffic["long_reads"] is True and spec.traffic["reads_per_sample"] == 300_000
    assert set(spec.traffic["assumed"]) and spec.traffic["source"] and spec.traffic["deployment"]
    with pytest.raises(SystemExit, match="run_multi_bam"):
        H.load_spec("chr21.longread", {"traffic": {"samples_per_call": 2}})


def test_check_time_fits(bench):
    """A full check of 24 cells at run_seconds fits its time."""
    n = 24
    assert (2 + 14 * n) * (bench["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200
    assert not math.isnan(bench["run_seconds"])
