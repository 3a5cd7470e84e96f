"""Time variants of K4's banded search kernel against each other on one card.

    python3 scripts/k4_variants.py

Each variant is ``csrc/select_windows.cu`` with its block size (kThreads),
its run length (kRun), the number of blocks it aims to launch
(kBlocksTarget, which sets how many blocks share a tile) and its block
order (raster, or the bottom tile row first) rewritten, built by nvcc into
a library of its own in a temporary directory.  On doc512 at W=64, R=128
and W=40, R=64, and on a 3300 x 2550 letter page (doc512 tiled and
cropped) at W=64, R=128 (T=1 throughout), each variant is checked exact
against ``select_windows_plain`` and timed by ``torch.profiler``'s device
time of its search kernel (mean of 20 launches) in three interleaved
rounds, so that the variants are compared within one call on one card.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from binary_image_compression_tpu_torch.ops import _cuda  # noqa: E402
from binary_image_compression_tpu_torch.ops import fused_search as fs  # noqa
from binary_image_compression_tpu_torch.ops import select_windows as sw  # noqa
from binary_image_compression_tpu_torch.utils import pnm  # noqa: E402

# name: (kThreads, kRun, kBlocksTarget, bottom tile row first)
VARIANTS = {f"{t} threads, runs of {r}, {g} blocks": (t, r, g, True)
            for t in (128, 256) for r in (4, 6, 8, 12)
            for g in (528, 1056, 2112)}
VARIANTS["256 threads, runs of 8, 1056 blocks, raster"] = (256, 8, 1056,
                                                           False)


def variant_source(src: str, threads: int, run: int, target: int,
                   reverse: bool) -> str:
    for pat, rep in ((r"constexpr int kThreads = \d+;",
                      f"constexpr int kThreads = {threads};"),
                     (r"constexpr int kRun = \d+;",
                      f"constexpr int kRun = {run};"),
                     (r"constexpr int kBlocksTarget = \d+;",
                      f"constexpr int kBlocksTarget = {target};")):
        src, n = re.subn(pat, rep, src)
        assert n == 1, pat
    t = ("p.T - 1 - (int)(blockIdx.x / p.slices)" if reverse
         else "(int)(blockIdx.x / p.slices)")
    src, n = re.subn(r"const int t = p\.T - 1 - \(int\)\(blockIdx\.x / "
                     r"p\.slices\);", f"const int t = {t};", src)
    assert n == 1, "block order"
    return src


def build(tmp: str) -> dict:
    shutil.copytree(_cuda.CSRC, os.path.join(tmp, "csrc"))
    base = open(os.path.join(tmp, "csrc", "select_windows.cu")).read()
    procs = {}
    for i, (name, v) in enumerate(VARIANTS.items()):
        src = os.path.join(tmp, "csrc", f"k4_v{i}.cu")
        open(src, "w").write(variant_source(base, *v))
        lib = os.path.join(tmp, f"k4_v{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (path, proc) in procs.items():
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err[-3000:]}")
        lib = ctypes.CDLL(path)
        lib.bic_select_windows.restype = i
        lib.bic_select_windows.argtypes = [p] * 3 + [i] * 16 + [p]
        lib.bic_banded_plane.restype = i
        lib.bic_banded_plane.argtypes = [p, p] + [i] * 5 + [p]
        libs[name] = lib
    return libs


def device_ms(fn, reps: int = 20):
    """Mean device time of the search kernel per call, by torch.profiler."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "banded_search_kernel" in e.key)
    return us / 1e3 / reps if us else float("nan")


def letter_page(doc: np.ndarray) -> np.ndarray:
    """A US letter page at 300 dpi, 3300 x 2550: doc512 tiled and cropped."""
    return np.tile(doc, (7, 5))[:3300, :2550]


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_variants: torch.cuda is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    doc = pnm.read_pbm(os.path.join(REPO, "tests", "fixtures", "doc512.pbm"))
    cases = {}
    for name, page, W, R in (("doc512 W=64 R=128", doc, 64, 128),
                             ("doc512 W=40 R=64", doc, 40, 64),
                             ("letter 3300x2550 W=64 R=128",
                              letter_page(doc), 64, 128)):
        rows, cols = page.shape
        ny, nx = -(-rows // W), -(-cols // W)
        grid = np.zeros((1, ny * W, nx * W), dtype=bool)
        grid[0, :rows, :cols] = page
        img = torch.from_numpy(grid).to(dev)
        kw = dict(W=W, R=R, T_thresh=1, cols=cols, invert=True)
        E = sw._launch_plane(img, W, fs.plane_height(ny * W, W, R))
        cases[name] = (E, ny, nx, kw, sw.select_windows_plain(E, ny, nx,
                                                              **kw))
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        base_lib = _cuda.get_lib()
        times = {(v, c): [] for v in libs for c in cases}
        for _ in range(3):
            for vname, lib in libs.items():
                _cuda._lib = lib
                for cname, (E, ny, nx, kw, want) in cases.items():
                    got = sw._launch(E, ny, nx, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"{vname} disagrees on {cname}")
                    times[(vname, cname)].append(device_ms(
                        lambda: sw._launch(E, ny, nx, **kw)))
        _cuda._lib = base_lib
    for (vname, cname), t in times.items():
        print(f"K4 search, {vname}, {cname}: "
              + " / ".join(f"{x:.4f}" for x in t)
              + f" ms on the device (3 rounds) [{gpu}]")
    for cname in cases:
        best = min(libs, key=lambda v: min(times[(v, cname)]))
        print(f"fastest on {cname}: {best}, "
              f"{min(times[(best, cname)]):.4f} ms [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
