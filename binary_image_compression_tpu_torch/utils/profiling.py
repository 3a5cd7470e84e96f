"""Spans, counters and stage timers.

Counterpart of ``binary_image_compression_tpu/utils/profiling.py``:
``StageStats`` and ``PipelineProfile`` (wall clock and bytes per named
stage, ``compress --profile``).  JAX's ``device_trace`` (a
``jax.profiler`` scope) has no counterpart: ``torch.profiler`` is used as
it is, and the recorder below puts the program's own spans on its clock.

The recorder (one a process, off by default; ``record(True)`` switches it
on, ``take()`` returns what it kept and empties it):

  * ``span(name)``: a context manager that times its block.  A kept
    ``Span`` has its name, its start and end on ``time.time_ns()`` (the
    clock of ``torch.profiler``'s events, so a span encloses the events of
    the work it enqueues or waits for), its parent (the span open on the
    same thread, or the one passed as ``parent``), a request id and its
    thread.  A span with no parent starts a request: the encoders open
    ``page`` (one page of ``compress.encode`` or ``encode_scab``) and
    ``archive_job`` (one ``archive.encode_archive``), and every span under
    one shares its id.  Work handed to another thread passes the span it
    belongs to as ``parent`` (a thread's own stack would lose it).
  * ``count(name, n)``: (name, n, time.time_ns(), the open span), kept
    beside the spans.

Off, ``span()`` returns one shared no-op after a single flag test and
``count()`` keeps nothing.  Neither ever synchronises the device, reads a
tensor's value or copies: a span around a host wait measures a wait that
the program makes anyway.  A ``PipelineProfile`` stage is timed by the
same ``Span``, kept by the profile's ``StageStats`` in place of the
recorder, so its stages are timed whether the recorder is on or not.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field


class Span:
    """One timed block: [start, end) on ``time.time_ns()``."""

    __slots__ = ("name", "start", "end", "parent", "request", "thread",
                 "_rec")

    def __init__(self, name: str, parent: "Span | None" = None,
                 request: int = 0, rec: "Recorder | None" = None):
        self.name, self.parent, self.request = name, parent, request
        self.start = self.end = 0
        self.thread = 0
        self._rec = rec

    def __enter__(self) -> "Span":
        self.thread = threading.get_ident()
        if self._rec is not None:
            self._rec._stack().append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.time_ns()
        if self._rec is not None:
            self._rec._keep(self)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class _Off:
    """The recorder's span while it is off: does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


OFF = _Off()


class Recorder:
    """Spans and counts of every thread of the process (see the module's
    docstring)."""

    def __init__(self):
        self.on = False
        self.spans: list[Span] = []
        self.counts: list[tuple] = []     # (name, n, time_ns, open span)
        self._local = threading.local()
        self._requests = itertools.count(1)

    def record(self, on: bool = True) -> None:
        self.on = bool(on)

    def take(self) -> tuple[list[Span], list[tuple]]:
        """(spans in the order they ended, counts) kept so far; the
        recorder keeps nothing of them."""
        spans, counts = self.spans, self.counts
        self.spans, self.counts = [], []
        return spans, counts

    def span(self, name: str, parent: Span | None = None):
        if not self.on:
            return OFF
        if not isinstance(parent, Span):
            parent = self.current()
        request = parent.request if parent else next(self._requests)
        return Span(name, parent, request, self)

    def current(self) -> Span | None:
        """The innermost span open on this thread (None while off)."""
        stack = self._stack() if self.on else None
        return stack[-1] if stack else None

    def count(self, name: str, n: int) -> None:
        if self.on:
            self.counts.append((name, int(n), time.time_ns(),
                                self.current()))

    def _stack(self) -> list[Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _keep(self, sp: Span) -> None:
        self._stack().remove(sp)
        self.spans.append(sp)


RECORDER = Recorder()
record = RECORDER.record
take = RECORDER.take
span = RECORDER.span
count = RECORDER.count


def write_jsonl(path: str, spans: list[Span], counts: list[tuple]) -> None:
    """What ``take()`` gave, as JSON lines: {"span", "id", "parent",
    "request", "thread", "start_ns", "end_ns"} a span (id: its line among
    the spans, which end in order; parent: the parent's id), then
    {"count", "n", "t_ns", "within"} a count (within: the id of the span
    open when it was counted)."""
    import json
    ids = {id(s): i for i, s in enumerate(spans)}
    with open(path, "w") as f:
        for i, s in enumerate(spans):
            f.write(json.dumps(dict(
                span=s.name, id=i, parent=ids.get(id(s.parent)),
                request=s.request, thread=s.thread, start_ns=s.start,
                end_ns=s.end)) + "\n")
        for name, n, t, sp in counts:
            f.write(json.dumps(dict(count=name, n=n, t_ns=t,
                                    within=ids.get(id(sp)))) + "\n")


def read_jsonl(path: str) -> tuple[list[Span], list[tuple]]:
    """What ``write_jsonl`` wrote, as ``take()`` gave it: the spans with
    their parents linked, and the counts with the span they were counted
    within."""
    import json
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    made: dict[int, Span] = {}
    parents: dict[int, int | None] = {}
    for d in lines:
        if "span" in d:
            s = Span(d["span"], None, d["request"])
            s.start, s.end, s.thread = d["start_ns"], d["end_ns"], d["thread"]
            made[d["id"]], parents[d["id"]] = s, d["parent"]
    for i, s in made.items():
        s.parent = made.get(parents[i])
    counts = [(d["count"], d["n"], d["t_ns"], made.get(d["within"]))
              for d in lines if "count" in d]
    return list(made.values()), counts


@dataclass
class StageStats:
    seconds: float = 0.0
    bytes_moved: int = 0
    calls: int = 0

    @property
    def mbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e6 if self.seconds else 0.0


@dataclass
class PipelineProfile:
    stages: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        st = self.stages.setdefault(name, StageStats())
        sp = Span(name)
        try:
            with sp:
                yield st
        finally:
            st.seconds += sp.seconds
            st.bytes_moved += nbytes
            st.calls += 1

    def report(self) -> str:
        lines = []
        for name, st in self.stages.items():
            lines.append(f"{name:24s} {st.seconds*1e3:9.2f} ms  "
                         f"{st.mbps:9.1f} MB/s  x{st.calls}")
        return "\n".join(lines)
