"""Time variants of K1's search kernel against each other on one card.

    python3 scripts/k1_variants.py

Each variant is ``csrc/fused_search.cu`` with its block size (kThreads),
its run length (kRun) and its block order (raster, or the bottom tile row
first) rewritten, built by nvcc into a
library of its own in a temporary directory.  On doc512 (W=16, R=128, T=1)
each variant is checked exact against ``fused_search_select_plain`` and
timed with CUDA events (mean of 50 launches) at 1 page and at a batch of 32
rolled pages, in three interleaved rounds, so that the variants are
compared within one call on one card.  The plane kernel of the checkout is
timed beside them, against ``_field_plane`` and a float32 ``conv2d`` with
the row kernel 2^(W-1) .. 2^0.  Needs a CUDA device and nvcc.
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
from binary_image_compression_tpu_torch.utils import pnm  # noqa: E402

# name: (kThreads, kRun, heaviest tiles first)
VARIANTS = {f"{t} threads, runs of {r}{', reversed' if rev else ''}":
            (t, r, rev)
            for t in (128, 256) for r in (8, 12, 16) for rev in (False, True)}
VARIANTS.update({f"256 threads, runs of {r}, reversed": (256, r, True)
                 for r in (10, 14, 20)})


def variant_source(src: str, threads: int, run: int, reverse: bool) -> str:
    for pat, rep in ((r"constexpr int kThreads = \d+;",
                      f"constexpr int kThreads = {threads};"),
                     (r"constexpr int kRun = \d+;",
                      f"constexpr int kRun = {run};")):
        src, n = re.subn(pat, rep, src)
        assert n == 1, pat
    # reversed: the bottom tile row (the heaviest) first
    t = "p.T - 1 - blockIdx.x" if reverse else "blockIdx.x"
    src, n = re.subn(r"const int t = [^,;]*, b = blockIdx\.y;",
                     f"const int t = {t}, b = blockIdx.y;", src)
    assert n == 1, "block order"
    return src


def build(tmp: str) -> dict:
    shutil.copytree(_cuda.CSRC, os.path.join(tmp, "csrc"))
    base = open(os.path.join(tmp, "csrc", "fused_search.cu")).read()
    procs = {}
    for i, (name, v) in enumerate(VARIANTS.items()):
        src = os.path.join(tmp, "csrc", f"k1_v{i}.cu")
        open(src, "w").write(variant_source(base, *v))
        lib = os.path.join(tmp, f"k1_v{i}.so")
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{err[-3000:]}")
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bic_fused_search_select.restype = i
        lib.bic_fused_search_select.argtypes = [p, p] + [i] * 16 + [p]
        libs[name] = lib
    return libs


def events_ms(fn, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_variants: torch.cuda is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    W, R, T_thresh, n = 16, 128, 1, 512
    doc = pnm.read_pbm(os.path.join(REPO, "tests", "fixtures", "doc512.pbm"))
    rs = np.random.RandomState(2)
    pages = np.stack([doc] + [np.roll(doc, (rs.randint(n), rs.randint(n)),
                                      axis=(0, 1)) for _ in range(31)])
    img32 = torch.from_numpy(pages).to(dev)
    He = fs.plane_height(n, W, R)
    kw = dict(W=W, R=R, T_thresh=T_thresh, cols=n, invert=True, y_base=0)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        base_lib = _cuda.get_lib()
        E32 = fs._launch_plane(img32, W, He)
        planes = {B: E32[:B].contiguous() for B in (1, 32)}
        want = {B: fs.fused_search_select_plain(E, 32, 32, **kw)
                for B, E in planes.items()}
        times = {(name, B): [] for name in libs for B in planes}
        for rnd in range(3):
            for name, lib in libs.items():
                _cuda._lib = lib
                for B, E in planes.items():
                    got = fs._launch(E, 32, 32, **kw)
                    torch.cuda.synchronize()
                    if not torch.equal(got, want[B]):
                        raise AssertionError(f"{name} disagrees at B={B}")
                    times[(name, B)].append(
                        events_ms(lambda: fs._launch(E, 32, 32, **kw)))
        _cuda._lib = base_lib
    for (name, B), t in times.items():
        print(f"K1 search, {name}, doc512 x{B}: "
              + " / ".join(f"{x:.4f}" for x in t)
              + f" ms (3 rounds; {min(t) / B:.4f} ms per page) [{gpu}]")
    for B in (1, 32):
        img = img32[:B]
        x = torch.zeros((B, 1, He, n + W - 1), dtype=torch.float32,
                        device=dev)
        x[:, 0, :n, :n] = img
        w = (2.0 ** torch.arange(W - 1, -1, -1, device=dev)).view(1, 1, 1, W)
        plane = fs._launch_plane(img, W, He)
        if not torch.equal(plane, fs.to_i32(fs._field_plane(img, W, He, n))):
            raise AssertionError("plane kernel != _field_plane")
        conv_ok = torch.equal(torch.nn.functional.conv2d(x, w)[:, 0].round()
                              .to(torch.int64), plane.to(torch.int64))
        t_k = events_ms(lambda: fs._launch_plane(img, W, He))
        t_p = events_ms(lambda: fs._field_plane(img, W, He, n), 10)
        t_c = events_ms(lambda: torch.nn.functional.conv2d(x, w))
        print(f"plane, doc512 x{B}: kernel {t_k:.4f} ms, _field_plane "
              f"{t_p:.4f} ms, conv2d {t_c:.4f} ms (exact: {conv_ok}) [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
