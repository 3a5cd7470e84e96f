"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the reference that decides ``correct``.

Everything the run uses is found by name (``core/cell.py``): the pages
from the traffic's ``pages`` (``core/pages.py``), the loop that drives the
window (``loops/<loop>.py``), the program's entries
(``programs/<program>.py``), the reference (``reference/<reference>.py``)
and the metric readers.  A loop warms the cell's one shape, times, and
adds the checks of what it drove.  The reference runs after the window,
once the peak memory has been read and the program's cached device memory
released.

Set-up is timed by its parts as well (the result's ``set_up``): the
imports before the run, the device's context, the pages, the builds of the
program's kernels and native library (``built`` says whether this run
made them; only a checkout's first run does), and the rest, chiefly the
warm-up.
"""

from __future__ import annotations

import collections
import gc
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch

from binary_image_compression_tpu_torch.models import compress
from binary_image_compression_tpu_torch.ops import _cuda
from binary_image_compression_tpu_torch.utils import profiling
from core import checks as checks_mod
from core import pages as pages_mod
from core import tracing
from core.cell import Cell, load, load_reader

BUILDS = [("binary_image_compression_tpu_torch.ops._cuda", "build"),
          ("binary_image_compression_tpu_torch.native", "build")]


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def card_info() -> dict:
    """The card's name, power limit and SM clock (nvidia-smi), as read."""
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        vals = [v.strip() for v in r.stdout.splitlines()[0].split(",")]
        return dict(zip(q.split(","), vals))
    except (OSError, IndexError, subprocess.SubprocessError):
        return {}


class Window:
    """Opens and closes the measured window: host clock, and in a traced
    run the profiler, with the spans and stage timers emptied of set-up."""

    def __init__(self, profiler, spans, profile, launches):
        self.profiler, self.spans, self.profile = profiler, spans, profile
        self.launches = launches        # the program's launch counter

    def begin(self, device) -> None:
        _sync(device)
        gc.collect()
        gc.freeze()
        if self.spans is not None:
            self.spans.clear()
        self.profile.stages.clear()
        self.launches0 = collections.Counter(self.launches)
        if self.profiler:
            self.profiler.start()
        self.t0 = time.perf_counter()

    def end(self) -> None:
        self.t1 = time.perf_counter()
        if self.profiler:
            self.profiler.stop()
        self.launched = collections.Counter(self.launches)
        self.launched.subtract(self.launches0)
        gc.unfreeze()


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: float, program=None) -> tuple[dict, list]:
    """One run: (the result object, ``correct`` ... ``checks``; the lines
    for standard error, ending with every check beside its limit).
    `program` stands in for the configuration's program module where
    given (the control)."""
    t_run = time.perf_counter()
    cuda = str(device).startswith("cuda")
    cfg, tr = cell.config, cell.traffic
    torch.empty(1, device=device)                  # the device's context
    _sync(device)
    t_pages = time.perf_counter()
    t_device = t_pages - t_run
    pool = pages_mod.make_pool(tr["pages"], seed)
    t_pages = time.perf_counter() - t_pages
    loop = load("loops", tr["loop"])
    program = program or load("programs", cfg["program"])
    reference = load("reference", cfg["reference"])
    metrics = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: load_reader(m["name"]) for m in metrics}
    host_route0 = compress.host_route["pages"]
    profile = profiling.PipelineProfile()
    builds = tracing.Spans()
    for module, attr in BUILDS:
        builds.wrap(module, attr, "build", False)
    spans = tracing.install(readers.values()) if trace else None
    profiler = tracing.Profiler() if trace else None
    if trace and tr.get("trace_seconds"):
        seconds = min(seconds, tr["trace_seconds"])
    win = Window(profiler, spans, profile, _cuda.launches)
    w = loop.run(cell, pool, seconds, device, program, win)
    w.setup_s = w.t_window - t_start
    builds.restore()
    if spans is not None:
        spans.restore()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = profiler.summary(spans.intervals) if profiler else None
    card = card_info() if cuda else {}
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ck = checks_mod.Checks()
    ck.add("host_route_pages", compress.host_route["pages"] - host_route0)
    loop.compare(cell, w, pool, seed, device, ck, reference)
    t_ref = time.perf_counter() - t_ref
    ctx = SimpleNamespace(cell=cell, window=w, pool=pool, device=device,
                          spans=spans and spans.seconds, profile=profile,
                          trace=summary, launches=win.launched)
    t_read = time.perf_counter()
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": ck.correct, "attempted": w.pages,
              "failed": w.failed, "metrics": values, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        ops = sorted(summary.op_seconds().items(), key=lambda kv: -kv[1])
        gaps = sorted(summary.idle_by_span().items(), key=lambda kv: -kv[1])
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
    result["card"] = card
    build_s = sum(builds.seconds["build"])
    before = t_run - t_start
    result["set_up"] = {
        "built": bool(builds.seconds["build"]), "build_s": build_s,
        "imports_s": before, "device_s": t_device, "pages_s": t_pages,
        "rest_s": w.setup_s - before - t_device - t_pages - build_s}
    result["checks"] = ck.as_dict()
    lines = [
        f"phases: set-up {w.setup_s:.3f} s (builds {build_s:.3f} s), "
        f"window {w.seconds:.3f} s, reference {t_ref:.3f} s, readers "
        f"{time.perf_counter() - t_read:.3f} s",
        "steps (ms): n {}, p10 {:.3f}, median {:.3f}, p90 {:.3f}, max "
        "{:.3f}".format(len(w.steps), *np.percentile(w.steps * 1e3,
                                                     [10, 50, 90, 100]))
    ]
    return result, lines + ck.lines()
