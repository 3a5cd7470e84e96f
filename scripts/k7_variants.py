"""Time variants of kernel K7 (codec 13's interleaved-rANS encode) on one
card, to find where a step's clocks go.

    python3 scripts/k7_variants.py [--reps N]

Builds ``binary_image_compression_tpu_torch/csrc/rans_encode.cu`` once per
variant with -D switches (nvcc for sm_90a, one process per variant, all
started together) and K7's first design, ``scripts/k7_first_design.cu``,
builds the port's kernels, and times each variant by torch.profiler's device time
(mean of N launches, min of three) on doc512 and on a 3300 x 2550 letter
page (doc512 tiled), each at codec 13's defaults (32 lanes; 4 and 16
stripes) with the table the page builds on the card.  Variants that keep
the arithmetic must equal the port's K7 exactly; the others
(``K7_NO_DIVIDE``, ``K7_NO_EMIT``) give wrong streams and time what they
leave out.  ``K7_MAX_STAGES`` caps the ring of staged inputs (11 stages of
32 steps at 32 lanes by default; as many producer warps as stages at
most), ``K7_PRODUCERS`` sets the producer warps (11 beside one chain warp
by default).  Prints the card's name and power limit,
a line per variant with its clocks per step at the boost clock, and one
JSON line.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEW = os.path.join(HERE, "binary_image_compression_tpu_torch", "csrc",
                   "rans_encode.cu")
FIRST = os.path.join(HERE, "scripts", "k7_first_design.cu")
OUT = os.path.join(HERE, "build", "k7_variants")
# name -> (source, -D switches, exact)
VARIANTS = {
    "K7": (NEW, {}, True),
    "ring of 4 stages (128 steps)": (NEW, {"K7_MAX_STAGES": 4}, True),
    "ring of 2 stages (64 steps)": (NEW, {"K7_MAX_STAGES": 2}, True),
    "ring of 1 stage (32 steps)": (NEW, {"K7_MAX_STAGES": 1}, True),
    "3 producer warps": (NEW, {"K7_PRODUCERS": 3}, True),
    "6 producer warps": (NEW, {"K7_PRODUCERS": 6}, True),
    "no divide (x >> 12)": (NEW, {"K7_NO_DIVIDE": 1}, False),
    "no emission": (NEW, {"K7_NO_EMIT": 1}, False),
    "no divide, no emission": (NEW, {"K7_NO_DIVIDE": 1, "K7_NO_EMIT": 1},
                               False),
    "first design": (FIRST, {}, True),
}


def gpu_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def build(nvcc: str, flags: list) -> dict:
    """One shared library per variant, all nvcc processes at once."""
    os.makedirs(OUT, exist_ok=True)
    libs, procs = {}, []
    for i, (name, (src, defs, _)) in enumerate(VARIANTS.items()):
        lib = os.path.join(OUT, f"k7v{i}.so")
        d = [f"-D{k}={v}" for k, v in defs.items()]
        procs.append((name, lib, subprocess.Popen(
            [nvcc, *flags, *d, "-shared", "-o", lib, src],
            stderr=subprocess.PIPE, text=True)))
    for name, lib, proc in procs:
        err = proc.communicate(timeout=600)[1]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err[-3000:]}")
        libs[name] = lib
    return libs


def chain_sass(lib: str) -> tuple[int, float]:
    """(instructions, per step) of K7's chain over one 32-step stage in
    the SASS of `lib` (``cuobjdump -sass``): the 32-bit-offset, 32-step
    instance, from the chain's wait on a full stage to its arrival on the
    empty barrier (the span that loads 32 records, LDS.128)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    fn = next(f for f in sass.split("Function : ")
              if "rans_encode_kernelIiLi32E" in f.split("\n", 1)[0])
    ops = [m.group(1).strip() for m in
           re.finditer(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", fn)]
    spans, start = [], None
    for k, op in enumerate(ops):
        if "TRYWAIT" in op:
            start = k
        elif "SYNCS.ARRIVE" in op and start is not None:
            spans.append(ops[start:k + 1])
            start = None
    n = min(len(sp) for sp in spans
            if sum(op.startswith("LDS.128") for op in sp) == 32)
    return n, n / 32


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
    n_sass, per_step = chain_sass(libs["K7"])
    print(f"K7 chain SASS: {n_sass} instructions over a 32-step stage, "
          f"{per_step:.1f} a step (cuobjdump -sass)", flush=True)
    fns = {}
    for name, path in libs.items():
        new = VARIANTS[name][0] == NEW
        fn = ctypes.CDLL(path).bic_rans_encode
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * (9 if new else 7) + [
            ctypes.c_int] * 7 + [ctypes.c_void_p]
        fns[name] = (fn, new)

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
        magic = rd.magic_table(dev)

        def launcher(fn, new):
            def run():
                out = (torch.empty((S, 32), dtype=torch.int32, device=dev),
                       torch.zeros((S, wcap), dtype=torch.int32, device=dev),
                       torch.empty(S, dtype=torch.int64, device=dev))
                scratch = torch.empty((S, steps * 32), dtype=torch.int16,
                                      device=dev)
                flags = torch.empty((S, -(-steps // 32) * 32),
                                    dtype=torch.int32, device=dev)
                ptr = lambda t: ctypes.c_void_p(t.data_ptr())
                mid = [ptr(magic), ptr(scratch), ptr(flags)] if new else [
                    ptr(scratch)]
                _cuda.check(fn(ptr(a[0]), ptr(a[1]), ptr(a[2]), *mid,
                               ptr(out[0]), ptr(out[1]), ptr(out[2]), 1,
                               rows, cols, S, sr, steps, 32,
                               _cuda.stream(dev)), "K7 variant")
                return out
            return run

        result[page] = {}
        for name, (fn, new) in fns.items():
            run = launcher(fn, new)
            got = run()
            torch.cuda.synchronize()
            same = all(torch.equal(g, w.reshape(g.shape))
                       for g, w in zip(got, want))
            if VARIANTS[name][2] and not same:
                raise AssertionError(f"{name} != K7 on {page}")
            best = None
            for _ in range(3):
                with torch.profiler.profile(activities=acts) as prof:
                    for _ in range(args.reps):
                        run()
                    torch.cuda.synchronize()
                us = sum(e.device_time_total for e in prof.key_averages()
                         if "rans_encode_kernel" in e.key)
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
    print(json.dumps({"gpu": gpu, "chain_sass_per_step": per_step,
                      "k7_variants": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
