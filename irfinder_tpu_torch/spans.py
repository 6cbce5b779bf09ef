"""Spans: the seconds a sample spends in each named phase of the program.

``span(to, name)`` is a context manager around one phase.  It reads the
host clock at each end (``time.perf_counter``) and adds the seconds to
``RunMetrics.spans[name]`` of every target, summed over the sample; the
phases that carry a RunMetrics field of their own (SPAN_FIELDS: decode,
finalize, checkpoint) add to that field too.  It never synchronizes the
device: a span around an asynchronous launch measures the enqueue, and
device durations come from a profiler's device trace.

While a ``torch.profiler`` is recording, the span also opens
``record_function("irf." + name)``, so the phase lands in the profiler's
chrome trace on the profiler's clock, nested under whatever range the
caller holds.  A sample that has an index in its call (batch mode,
``RunMetrics.sample``), alone or as a list of one, gets it in the range's
name: ``irf.write.ROI sample=1``.  There is no switch: with no profiler recording, a span costs
two clock reads and a dict update.  Ranges on threads other than the one
that started the profiler are recorded only by a profiler that profiles
all threads (``cli.py --profile`` does where the installed torch can).

``to`` is one RunMetrics, a list of them, or None (measure only: ``.s``).
A list is read when the span closes, so a phase that makes the samples'
states can fill it inside the span.  With ``split``, the seconds are
shared out evenly over the list (batch mode's set-up and its one
statistics launch for all samples); without, each target gets them all
(batch mode's shared stream).  Each name of one RunMetrics is written by
one thread: the feeder threads own ``decode``, ``stage`` and ``route``, the
calling thread every other name.
"""

from __future__ import annotations

import time

import torch.autograd.profiler as _profiler

#: prefix of every span's profiler range
PREFIX = "irf."
#: span name -> the RunMetrics field that sums the same seconds
SPAN_FIELDS = {"decode": "decode_s", "finalize": "finalize_s", "checkpoint": "checkpoint_s"}


class span:
    """``with span(metrics, "write.ROI"): ...`` (see the module docstring).
    After the block, ``.s`` holds its seconds."""

    __slots__ = ("to", "name", "split", "s", "_t0", "_range")

    def __init__(self, to, name: str, split: bool = False):
        self.to = to
        self.name = name
        self.split = split
        self.s = 0.0
        self._range = None

    def __enter__(self) -> "span":
        if _profiler._is_profiler_enabled:
            label = PREFIX + self.name
            one = self.to[0] if isinstance(self.to, list) and len(self.to) == 1 else self.to
            sample = getattr(one, "sample", None)
            if sample is not None:
                label += f" sample={sample}"
            self._range = _profiler.record_function(label)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.s = time.perf_counter() - self._t0
        to = self.to
        if to is not None:
            targets = to if isinstance(to, list) else (to,)
            dt = self.s / len(targets) if self.split and targets else self.s
            field = SPAN_FIELDS.get(self.name)
            for m in targets:
                m.spans[self.name] = m.spans.get(self.name, 0.0) + dt
                if field is not None:
                    setattr(m, field, getattr(m, field) + dt)
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return False
