"""The window keeps the tables of a sample of its calls for the check, drawn
from the seed, and deletes the others' as each call returns: the first call
and one in KEEP_EVERY.  A fault in the kept calls other than the first still
makes the run not correct."""

import itertools
import re
import types

import pytest

from portbench import harness as H


@pytest.mark.parametrize("seed", [0, 1, 5, 2**31 + 5, 2**40 + 3])
def test_kept_calls_drawn_from_seed(seed):
    ks = [k for k in range(8 * H.KEEP_EVERY) if H.kept_calls(seed)(k)]
    assert ks == [k for k in range(8 * H.KEEP_EVERY) if H.kept_calls(seed)(k)]
    assert ks[0] == 0 and len(ks) in (8, 9)
    assert all((b - a) in (H.KEEP_EVERY, ks[1]) for a, b in zip(ks, ks[1:]))


def test_offsets_vary_with_seed():
    offsets = {min(k for k in range(1, H.KEEP_EVERY + 1) if H.kept_calls(s)(k))
               for s in range(64)}
    assert len(offsets) == H.KEEP_EVERY


def _run(small, monkeypatch, seconds):
    """A small CPU run of chr21.paired at KEEP_EVERY 2 on a clock that
    moves 0.1 s each time the harness reads it (three readings a call), so
    that a window of ``seconds`` holds the same number of calls however
    long each takes on a loaded host."""
    monkeypatch.setattr(H, "KEEP_EVERY", 2)
    monkeypatch.setattr(H, "time", types.SimpleNamespace(
        perf_counter=itertools.count(0.0, 0.1).__next__))
    lines = []
    r = H.run_cell("chr21.paired", 2**31 + 7, seconds, False, 0.0,
                   device="cpu", overrides=small, log=lines.append)
    disk = next(l for l in lines if l.startswith("disk:"))
    kept, n = map(int, re.search(r"\((\d+) of (\d+) calls\)", disk).groups())
    return r, kept, n


def test_unkept_tables_deleted(small, monkeypatch):
    """Only the kept calls' tables stay on disk; every call is attempted."""
    r, kept, n = _run(small, monkeypatch, 2.0)
    assert r["correct"] and r["attempted"] == n
    assert n >= 4 and 2 <= kept < n
    assert kept == sum(H.kept_calls(2**31 + 7)(k) for k in range(n))


def test_fault_after_first_call_is_not_correct(small, monkeypatch):
    """An answer altered in every call but the first is caught in the
    kept calls after it."""
    import irfinder_tpu_torch.engine as E

    orig, seen = E.result_bundle, []

    def altered(ref, joined, fc, cache):
        out = orig(ref, joined, fc, cache)
        seen.append(1)
        if len(seen) > 2:  # the warm-up and the window's first call are sound
            hits = out["counters"]["span_hits"].copy()
            hits[0, 0] += 1
            out["counters"]["span_hits"] = hits
        return out

    monkeypatch.setattr(E, "result_bundle", altered)
    r, kept, n = _run(small, monkeypatch, 2.0)
    assert kept >= 2
    assert not r["correct"] and r["checks"]["spans_point_lines"]["value"] > 0
