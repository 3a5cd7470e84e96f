"""Time variants of kernel K7 (codec 13's interleaved-rANS encode) on one
card, to find where a step's clocks go.

    python3 scripts/k7_variants.py [--reps N]

Builds ``scripts/k7_variants.cu`` once per variant (nvcc for sm_90a, one
process per variant, all started together), builds the port's kernels,
and times each variant and the port's K7 by torch.profiler's device time
(mean of N launches, min of three) on doc512 and on a 3300 x 2550 letter
page (doc512 tiled), each at codec 13's defaults (32 lanes; 4 and 16
stripes) with the table the page builds on the card.  Variants that keep
the arithmetic must equal the port's K7 exactly; the others
(``K7_DIV=1``, ``K7_EMIT=0``) give wrong streams and time what they leave
out.  Prints the card's name and power limit, a line per variant with its
clocks per step at the boost clock, and one JSON line.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "scripts", "k7_variants.cu")
OUT = os.path.join(HERE, "build", "k7_variants")
# name -> (-D switches, exact)
VARIANTS = {
    "base (K7)": ({}, True),
    "chunk 4": ({"K7_CHUNK": 4}, True),
    "chunk 16": ({"K7_CHUNK": 16}, True),
    "32-bit indices": ({"K7_IDX64": 0}, True),
    "reciprocal table": ({"K7_DIV": 2}, True),
    "reciprocal table, 32-bit indices": ({"K7_DIV": 2, "K7_IDX64": 0}, True),
    "no divide (x >> 12)": ({"K7_DIV": 1}, False),
    "no emission": ({"K7_EMIT": 0}, False),
    "no divide, no emission": ({"K7_DIV": 1, "K7_EMIT": 0}, False),
}


def gpu_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def build(nvcc: str, flags: list) -> dict:
    """One shared library per variant, all nvcc processes at once."""
    os.makedirs(OUT, exist_ok=True)
    libs, procs = {}, []
    for i, (name, (defs, _)) in enumerate(VARIANTS.items()):
        lib = os.path.join(OUT, f"k7v{i}.so")
        d = [f"-D{k}={v}" for k, v in defs.items()]
        procs.append((name, lib, subprocess.Popen(
            [nvcc, *flags, *d, "-shared", "-o", lib, SRC],
            stderr=subprocess.PIPE, text=True)))
    for name, lib, proc in procs:
        err = proc.communicate(timeout=600)[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k7_variants: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from binary_image_compression_tpu_torch.models import codec, compress
    from binary_image_compression_tpu_torch.ops import _cuda
    from binary_image_compression_tpu_torch.ops import ransdevice as rd
    from binary_image_compression_tpu_torch.utils import pnm, roofline

    gpu = gpu_name()
    print(gpu, flush=True)
    libs = build(_cuda._nvcc(), _cuda.NVCC_FLAGS)
    _cuda.get_lib()
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(path).bic_rans_variant
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fns[name] = fn

    dev = torch.device("cuda", 0)
    doc = pnm.read_pbm(os.path.join(HERE, "tests", "fixtures", "doc512.pbm"))
    pages = {"doc512": doc, "letter": np.tile(doc, (7, 5))[:3300, :2550]}
    p = codec.CodecParams(codec=13, W=0, T=0, R=0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    result = {}
    for page, img in pages.items():
        rows, cols = img.shape
        tmpl, S, sr = codec.scab_stripes(p, rows)
        bits = compress.scab_upload(img, dev)
        ctx = compress.scab_ctx_map(bits, tmpl=tmpl, stripe_rows=sr)
        p_used = rd.build_table(*rd.count_contexts(ctx, bits))[3]
        a = (bits[None].view(torch.uint8), ctx[None],
             p_used.to(torch.int16)[None])
        want = rd._launch(*a, stripe_rows=sr, n_lanes=32)
        _, steps, wcap = rd.stripe_geometry(rows, cols, sr, 32)
        floor = roofline.rans_work(rows * cols, steps, S, 32)[1]

        def launcher(fn):
            def run():
                out = (torch.empty((S, 32), dtype=torch.int32, device=dev),
                       torch.zeros((S, wcap), dtype=torch.int32, device=dev),
                       torch.empty(S, dtype=torch.int64, device=dev))
                scratch = torch.empty((S, steps * 32), dtype=torch.int16,
                                      device=dev)
                ptr = lambda t: ctypes.c_void_p(t.data_ptr())
                _cuda.check(fn(ptr(a[0]), ptr(a[1]), ptr(a[2]), ptr(scratch),
                               ptr(out[0]), ptr(out[1]), ptr(out[2]), 1,
                               rows, cols, S, sr, steps, 32,
                               _cuda.stream(dev)), "bic_rans_variant")
                return out
            return run

        result[page] = {}
        for name, fn in fns.items():
            run = launcher(fn)
            got = run()
            torch.cuda.synchronize()
            same = all(torch.equal(g, w.reshape(g.shape))
                       for g, w in zip(got, want))
            if VARIANTS[name][1] and not same:
                raise AssertionError(f"{name} != K7 on {page}")
            best = None
            for _ in range(3):
                with torch.profiler.profile(activities=acts) as prof:
                    for _ in range(args.reps):
                        run()
                    torch.cuda.synchronize()
                us = sum(e.device_time_total for e in prof.key_averages()
                         if "rans_variant_kernel" in e.key)
                ms = us / 1e3 / args.reps if us else None
                best = ms if best is None or (ms and ms < best) else best
            clk = None if best is None else (
                best * 1e-3 * roofline.H100_CLOCK_HZ / steps)
            result[page][name] = dict(ms=best, clocks_per_step=clk,
                                      exact=same)
            print(f"{page} ({S} stripes, {steps} steps, floor {floor:.4f} "
                  f"ms): {name}: "
                  f"{'not measured' if best is None else f'{best:.4f} ms'}"
                  f"{'' if clk is None else f', {clk:.0f} clocks a step'}"
                  f"{'' if same else ' (stream differs)'} [{gpu}]",
                  flush=True)
    print(json.dumps({"gpu": gpu, "k7_variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
