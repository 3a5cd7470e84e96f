"""Stage timers and device traces.

Counterpart of ``binary_image_compression_tpu/utils/profiling.py``:
``StageStats`` and ``PipelineProfile`` (wall clock and bytes per named
stage, ``compress --profile``) on the host clock, and ``device_trace``,
which records a ``torch.profiler`` trace of the CPU and the card and writes
it as a Chrome trace.  A stage that ends in a device-to-host fetch (a
``.cpu()`` of the device's result) includes the device's work, as JAX's
``device_get`` does.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


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
        t0 = time.perf_counter()
        try:
            yield st
        finally:
            st.seconds += time.perf_counter() - t0
            st.bytes_moved += nbytes
            st.calls += 1

    def report(self) -> str:
        lines = []
        for name, st in self.stages.items():
            lines.append(f"{name:24s} {st.seconds*1e3:9.2f} ms  "
                         f"{st.mbps:9.1f} MB/s  x{st.calls}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Record a ``torch.profiler`` trace of the block (the card's kernels
    too where CUDA is available) and write it to
    ``<logdir>/trace.json`` (open it in chrome://tracing or Perfetto).
    Yields the profiler, whose ``key_averages()`` tables the block's
    operators."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
