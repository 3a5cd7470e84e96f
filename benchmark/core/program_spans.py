"""The program's own spans and counters (the recorder of the port's
``utils/profiling``), for the per-layer readers that read them.

A reader that imports this module switches the recorder on.  Only traced
runs load per-layer readers, so a run with ``--trace 0`` records nothing.
The recorder keeps everything from set-up on; ``window(ctx)`` takes it
once a run and keeps what started inside the measured window, whose start
and length the loops give on ``time.perf_counter()``: one paired reading
of that clock and ``time.time_ns()``, the recorder's, converts them.

Where the program has no recorder (a checkout older than it), nothing is
switched on and every function here returns None, so its readers report
nothing.
"""

from __future__ import annotations

import time

from binary_image_compression_tpu_torch.utils import profiling

_take = getattr(profiling, "take", None)
if _take is not None:
    profiling.record(True)

# request roots: idle time under them alone is not labelled by a layer
ROOTS = ("page", "archive_job")

_taken: dict = {}


def _all(ctx):
    """(spans, counts) the recorder kept up to this run's first read."""
    if _taken.get("window") is not ctx.window:
        _taken.update(window=ctx.window, got=_take())
    return _taken["got"]


def window_ns(ctx) -> tuple[int, int]:
    """The measured window as [start, end) on ``time.time_ns()``."""
    w = ctx.window
    offset = time.time_ns() - time.perf_counter_ns()
    t0 = round(w.t_window * 1e9) + offset
    return t0, t0 + round(w.seconds * 1e9)


def window(ctx):
    """(spans, counts) that started inside the window, or None where the
    program keeps none.  A span has ``name``, ``start``, ``end`` (ns),
    ``parent``, ``request`` and ``thread``; a count is (name, n, ns, the
    span open when it was counted)."""
    if _take is None:
        return None
    spans, counts = _all(ctx)
    t0, t1 = window_ns(ctx)
    return ([s for s in spans if t0 <= s.start < t1],
            [c for c in counts if t0 <= c[2] < t1])


def overlapping(ctx):
    """Spans open at any time in the window (None without a recorder)."""
    if _take is None:
        return None
    t0, t1 = window_ns(ctx)
    return [s for s in _all(ctx)[0] if s.start < t1 and s.end > t0]


def seconds(spans, name: str):
    """Summed seconds of the spans called `name`, or None if there are
    none."""
    ns = [s.end - s.start for s in spans if s.name == name]
    return sum(ns) / 1e9 if ns else None


def ms_a_page(ctx, name: str):
    """Milliseconds a page of the window's spans called `name`."""
    got = window(ctx)
    s = seconds(got[0], name) if got else None
    return None if s is None else s * 1e3 / ctx.window.pages


def h2d_gb_s(ctx):
    """GB/s of the uploads' copies: the ``h2d_bytes`` counted over the
    time of the ``upload.h2d`` spans."""
    got = window(ctx)
    if not got:
        return None
    spans, counts = got
    s = seconds(spans, "upload.h2d")
    nbytes = sum(n for name, n, _, _ in counts if name == "h2d_bytes")
    return nbytes / s / 1e9 if s and nbytes else None


def share_pct(ctx, part: str, whole: str):
    """The summed time of the spans called `part` over that of `whole`,
    %."""
    got = window(ctx)
    if not got:
        return None
    a, b = seconds(got[0], part), seconds(got[0], whole)
    return 100.0 * a / b if a and b else None


def idle_unattributed_pct(ctx):
    """Of the traced window's gaps between device operations, the share
    during which the innermost program span open is a request root or no
    program span is open, %."""
    from core.tracing import TraceSummary
    t, spans = ctx.trace, overlapping(ctx)
    if t is None or spans is None:
        return None
    idle = TraceSummary(t.device, [(s.start, s.end, s.name) for s in spans],
                        t.window_s).idle_by_span()
    total = sum(idle.values())
    if total <= 0:
        return None
    bare = sum(v for k, v in idle.items()
               if k in ROOTS or k == "outside any span")
    return 100.0 * bare / total
