"""The traced window: torch.profiler over the measured window, reduced to
what the per-layer readers and the result's ``breakdown`` need.

Host spans are the benchmark's own ``record_function`` ranges around its
calls into the program (``portbench.window``, ``portbench.call <i> <entry>``),
so every device interval and idle gap can be placed in the call it fell in.
A card's busy time is the union of its kernels, copies and sets, so
overlapping work on two streams counts once.  On several cards each card's
intervals are kept apart by the card the event ran on (``args.device``;
``args.inDevice`` for a copy between cards): the busy time is
the mean of the cards' unions, and an idle gap is a stretch in which no
card worked.  On one card both are the single union.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os

#: chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."


@dataclasses.dataclass
class Trace:
    """One traced window, seconds throughout."""

    window_s: float
    #: the mean over the run's cards of each card's busy seconds
    busy_s: float
    #: device time by operation name, summed over the cards
    device_time: dict
    #: (name, seconds) of the longest stretches in which no card worked,
    #: longest first
    idle_gaps: list
    #: busy seconds by the trace's device id
    card_busy_s: dict = dataclasses.field(default_factory=dict)


class Recorder:
    """Spans around the benchmark's calls; with ``enabled``, the profiler
    runs while the recorder is entered and ``result`` is its Trace.
    ``cards`` are the run's torch devices: each is synchronized before the
    profiler stops, and the busy time is their mean."""

    def __init__(self, enabled: bool, work: str, cards: list = ()):
        self.enabled = enabled
        self.cards = list(cards)
        self.path = os.path.join(work, "trace.json")
        self.result: Trace | None = None
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            import torch

            for d in self.cards or [None]:
                torch.cuda.synchronize(d)
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self._prof.export_chrome_trace(self.path)
                self.result = reduce(self.path, cards=max(1, len(self.cards)))
                os.remove(self.path)
        return False

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(SPAN_PREFIX + name)


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(path: str, top: int = 10, cards: int = 1) -> Trace:
    """The Trace of a chrome trace exported by torch.profiler, over a run on
    ``cards`` cards (a card with no work in the window counts as idle).
    Raises when the trace holds no window span or no device work."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    spans, dev = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            args = ev.get("args", {})
            # a copy between cards ("Memcpy PtoP") names the card it ran on
            # "inDevice" where other device events name it "device"; the
            # profiler also files each device event under its card's pid
            card = args.get("device", args.get("inDevice", ev.get("pid")))
            dev.append((ts, ts + dur, name, card))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((ts, ts + dur, name[len(SPAN_PREFIX):]))
    window = [s for s in spans if s[2] == "window"]
    if len(window) != 1:
        raise RuntimeError(f"trace: {len(window)} window spans")
    w0, w1 = window[0][:2]
    calls = sorted(s for s in spans if s[2] != "window")
    inside = [(max(s, w0), min(e, w1), n, d) for s, e, n, d in dev if e > w0 and s < w1]
    if not inside:
        raise RuntimeError("trace: no device work in the window")
    busy = _union([(s, e) for s, e, _, _ in inside])
    by_card: dict = collections.defaultdict(list)
    by_name: dict = collections.defaultdict(float)
    for s, e, n, d in inside:
        by_card[d if cards > 1 else 0].append((s, e))
        by_name[n] += (e - s) / 1e6
    card_busy = {d: sum(e - s for s, e in _union(iv)) / 1e6 for d, iv in by_card.items()}
    gaps, last = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)

    def where(t0: float, t1: float) -> str:
        mid = (t0 + t1) / 2
        for s, e, n in calls:
            if s <= mid <= e:
                return f"{n} at +{(t0 - s) / 1e6:.3f} s of {(e - s) / 1e6:.3f} s"
        return "harness, between calls"

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return Trace(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(card_busy.values()) / max(cards, len(card_busy)),
        device_time=dict(by_name),
        idle_gaps=[(where(s, e), (e - s) / 1e6) for s, e in gaps[:top]],
        card_busy_s=card_busy,
    )


def breakdown(tr: Trace, top: int = 10) -> dict:
    ops = sorted(tr.device_time.items(), key=lambda kv: kv[1], reverse=True)[:top]
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
