"""Spans around calls into the program, and the device trace.

Spans: in a traced run, each per-layer reader's ``SPANS`` names functions
of the program, ``("package.module", "attr", "span name", sync)``.  The
module attribute is replaced, for that run only, by a wrapper that times
the call on the host clock (ending in a ``torch.cuda.synchronize`` where
``sync``) and keeps its interval on ``time.time_ns()``, the clock of the
profiler's events, so that the trace can tell what the host was doing in
a device idle gap.  Callers inside the program look the name up in the
module at call time, so they take the wrapper too.

Trace: ``torch.profiler`` over the traced window, recording the device's
activity alone (kernels, copies, sets; the host's operators would add
~20 events a page and their cost).  Busy time is the union of the device
operations' intervals, so overlapping kernels count once; idle is the
window minus that.
"""

from __future__ import annotations

import collections
import functools
import importlib
import time

import torch
from torch.profiler import ProfilerActivity, profile

class Spans:
    def __init__(self):
        self.seconds: dict[str, list[float]] = collections.defaultdict(list)
        self.intervals: list[tuple[int, int, str]] = []   # time.time_ns()
        self._undo = []

    def wrap(self, module: str, attr: str, name: str, sync: bool) -> None:
        mod = importlib.import_module(module)
        orig = getattr(mod, attr)
        record, intervals = self.seconds[name], self.intervals

        @functools.wraps(orig)
        def timed(*args, **kwargs):
            t0, w0 = time.perf_counter(), time.time_ns()
            try:
                return orig(*args, **kwargs)
            finally:
                if sync and torch.cuda.is_available():
                    torch.cuda.synchronize()
                record.append(time.perf_counter() - t0)
                intervals.append((w0, time.time_ns(), name))

        setattr(mod, attr, timed)
        self._undo.append((mod, attr, orig))

    def clear(self) -> None:
        for v in self.seconds.values():
            v.clear()
        self.intervals.clear()

    def restore(self) -> None:
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()


def install(readers) -> Spans:
    """Wrap every function that the readers' SPANS name, once each."""
    spans, seen = Spans(), set()
    for r in readers:
        for module, attr, name, sync in getattr(r, "SPANS", ()):
            if (module, attr) not in seen:
                seen.add((module, attr))
                spans.wrap(module, attr, name, sync)
    return spans


class Profiler:
    """torch.profiler over one window; ``summary()`` after ``stop()``."""

    def __init__(self):
        acts = [ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU]
        # the first profile of a process starts the device tracer, which
        # takes seconds: do it once here, in set-up, on a trivial op
        with profile(activities=acts):
            if torch.cuda.is_available():
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self.window_s = 0.0

    def start(self) -> None:
        """Start tracing; the window's clock starts after it."""
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)

    def summary(self, spans=()) -> "TraceSummary":
        """The device operations of the trace, with the host spans (start
        ns, end ns, name) that label its idle gaps."""
        device = [(e.start_ns(), e.end_ns(), e.name())
                  for e in self._prof.profiler.kineto_results.events()
                  if "CPU" not in str(e.device_type())
                  and not e.is_user_annotation()]
        return TraceSummary(device, list(spans), self.window_s)


def union(intervals) -> list[tuple[int, int]]:
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


class TraceSummary:
    """Device operations (start_ns, end_ns, name) and host spans (start_ns,
    end_ns, name) on the profiler's clock, and the window's length."""

    def __init__(self, device, spans, window_s: float):
        self.device = device
        self.spans = spans
        self.window_s = window_s
        self.busy = union((s, e) for s, e, _ in device)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e9

    def op_seconds(self) -> dict[str, float]:
        out = collections.Counter()
        for s, e, name in self.device:
            out[name] += (e - s) / 1e9
        return dict(out)

    def kernel_seconds(self, match: str) -> tuple[float, int]:
        """(device seconds, launches) of the operations whose names hold
        `match`."""
        hits = [(e - s) for s, e, n in self.device if match in n]
        return sum(hits) / 1e9, len(hits)

    def idle_by_span(self) -> dict[str, float]:
        """Seconds of the gaps between device operations, split by what
        the host was doing: each stretch of a gap goes to the innermost
        host span open over it (the one opened last), or to "outside any
        span"."""
        points = []
        for i, (s, e, _) in enumerate(self.spans):
            points += [(s, 1, i), (e, 0, i)]
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            points += [(e0, 1, -1), (s1, 0, -1)]
        out = collections.Counter()
        open_spans, in_gap, last = [], False, None
        for t, opening, i in sorted(points):
            if in_gap and last is not None and t > last:
                label = (self.spans[open_spans[-1]][2] if open_spans
                         else "outside any span")
                out[label] += (t - last) / 1e9
            last = t
            if i < 0:
                in_gap = bool(opening)
            elif opening:
                open_spans.append(i)
            else:
                open_spans.remove(i)
        return dict(out)
