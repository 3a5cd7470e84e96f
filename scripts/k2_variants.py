"""Time variants of K2 (csrc/decide_modes.cu) against each other on one card.

    python3 scripts/k2_variants.py

Each variant is ``csrc/decide_modes.cu`` with its guard's serial bursts
(kShortRounds: how many rounds in a row that commit fewer than the guard's
tiles start a burst; kBurst: the most tiles a burst decides serially)
rewritten, built by nvcc into a library of its own in a
temporary directory, beside K2's serial design (``scripts/k2_serial.cu``).  On doc512's K2 inputs (W=16, R=128, one
page and 32 rolled pages), random weights (M = 256, T = 1,024 and 4,096),
the adversarial input (k changes on every tile) and a flat input (k never
changes after the first tile), each variant is checked exact against
``decide_modes_plain`` and timed by torch.profiler's device time (mean of
20 launches) under several guards, in three interleaved rounds, so that
the variants are compared within one call on one card.  Needs a CUDA
device and nvcc.
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

import chip_smoke as cs  # noqa: E402
from binary_image_compression_tpu_torch.models import compress  # noqa: E402
from binary_image_compression_tpu_torch.ops import _cuda  # noqa: E402
from binary_image_compression_tpu_torch.ops import decide as dc  # noqa: E402
from binary_image_compression_tpu_torch.utils import pnm  # noqa: E402

# name: (kShortRounds, kBurst); the first is the checkout's
VARIANTS = {f"{r} short rounds, burst {b}": (r, b)
            for r, b in ((2, 32), (1, 8), (1, 16), (1, 32), (3, 32))}
GUARDS = (0, 2, 4)


def variant_source(src: str, short: int, burst: int) -> str:
    for name, v in (("kShortRounds", short), ("kBurst", burst)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {v};", src)
        assert n == 1, name
    return src


def build(tmp: str) -> dict:
    shutil.copytree(_cuda.CSRC, os.path.join(tmp, "csrc"))
    base = open(os.path.join(tmp, "csrc", "decide_modes.cu")).read()
    procs = {}
    for i, (name, v) in enumerate(VARIANTS.items()):
        src = os.path.join(tmp, "csrc", f"k2_v{i}.cu")
        open(src, "w").write(variant_source(base, *v))
        lib = os.path.join(tmp, f"k2_v{i}.so")
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
        lib.bic_decide_modes.restype = i
        lib.bic_decide_modes.argtypes = [p] * 6 + [i] * 7 + [p]
        libs[name] = lib
    return libs


def inputs(dev) -> dict:
    """name -> (weights4, has_cands, idx_len, enb) int32 tensors on dev."""
    doc = pnm.read_pbm(os.path.join(cs.FIXTURES, "doc512.pbm"))
    rs = np.random.RandomState(2)
    pages = np.stack([doc] + [np.roll(doc, (rs.randint(512), rs.randint(512)),
                                      axis=(0, 1)) for _ in range(31)])
    out = compress.encode_analyze(torch.from_numpy(pages).to(dev), W=16,
                                  R=128, T_thresh=1, rows=512, cols=512)
    i32 = lambda t: t.to(torch.int32).contiguous()
    enb = torch.from_numpy(compress.enb_lut(256)).to(dev)
    a32 = (i32(out["weights4"]), i32(out["has_cands"]), i32(out["idx_len"]))
    got = {"doc512 x1": tuple(x[:1] for x in a32) + (enb,),
           "doc512 x32": a32 + (enb,)}
    rs = np.random.RandomState(5)
    for n in (1024, 4096):
        got[f"random T={n}"] = tuple(
            torch.from_numpy(x.astype(np.int32)).to(dev) for x in (
                rs.randint(0, 257, (1, n, 4)), rs.rand(1, n) < 0.8,
                rs.randint(1, 12, (1, n)))) + (enb,)
    got["adversarial"] = tuple(torch.from_numpy(x).to(dev)
                               for x in cs.adversarial_k2(256, 1024)) + (enb,)
    got["flat"] = (torch.zeros((1, 1024, 4), dtype=torch.int32, device=dev),
                   torch.zeros((1, 1024), dtype=torch.int32, device=dev),
                   torch.ones((1, 1024), dtype=torch.int32, device=dev), enb)
    return got


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_variants: torch.cuda is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    gpu = cs.card()
    serial_build = cs.start_k2_serial_build(_cuda)
    base_lib = _cuda.get_lib()
    serial = cs.load_k2_serial(_cuda, dc, serial_build)
    data = inputs(dev)
    want = {k: torch.stack(dc.decide_modes_plain(*x, codec_id=8), dim=-1)
            for k, x in data.items()}
    kern = "decide_modes_kernel"
    times, rounds = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        for rnd in range(3):
            for k, x in data.items():
                times.setdefault(("serial design", k, None), []).append(
                    cs.device_ms(lambda: serial(*x),
                                 "decide_modes_serial_kernel"))
            for name, lib in libs.items():
                _cuda._lib = lib
                for k, x in data.items():
                    for g in GUARDS:
                        got = torch.stack(dc._launch(*x, codec_id=8, guard=g),
                                          dim=-1)
                        torch.cuda.synchronize()
                        if not torch.equal(got, want[k]):
                            raise AssertionError(f"{name} disagrees on {k}")
                        times.setdefault((name, k, g), []).append(
                            cs.device_ms(lambda: dc._launch(
                                *x, codec_id=8, guard=g), kern))
                        rounds[(name, k, g)] = cs._k2_rounds(dc, x, g)
        _cuda._lib = base_lib
    for (name, k, g), t in times.items():
        r = "" if g is None else (
            f", guard {g}: rounds per page {min(rounds[(name, k, g)])}-"
            f"{max(rounds[(name, k, g)])}")
        print(f"K2 {name}, {k}{r}: " + cs.fmt(t)
              + f" ms on the device (3 rounds) [{gpu}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
