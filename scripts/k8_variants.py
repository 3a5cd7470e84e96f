"""Time variants of kernel K8 (codec 10's adaptive exp-Golomb coder) on one
card, kernel by kernel.

    python3 scripts/k8_variants.py [--reps N] [--only first]

Builds each variant as its own shared library (nvcc for sm_90a, one
process per variant, all started together): K8's first design
(``scripts/k8_first_design.cu``: five kernels, 64-word chunks, a thread
writing each chunk), the kernel of ``csrc/eg_encode.cu`` as it ships (16
or 64-word chunks, chosen by the stack) and with chunks fixed at 16, 32
and 64 words (``-DK8_CHUNK_WORDS``), and the same with one thread per
chunk writing its codes (``scripts/k8_variants.cu``).  Times each on
the residual stacks of the three gray pages of ``chip_smoke.py`` (the bench
stack, the 3300 x 2550 letter page and the noisy page): each kernel's
device time apart (torch.profiler keyed by kernel name, mean of N
launches; the payload's zero fill beside them),
the kernels' sum, and the time per launch by CUDA events.  Every variant
must equal ``egdevice.eg_encode_plain`` word for word.  Prints the card's
name and power limit, a line per variant and page, and one JSON line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST = os.path.join(HERE, "scripts", "k8_first_design.cu")
NEW = os.path.join(HERE, "binary_image_compression_tpu_torch", "csrc",
                   "eg_encode.cu")
THREAD = os.path.join(HERE, "scripts", "k8_variants.cu")
OUT = os.path.join(HERE, "build", "k8_variants")
# name -> (source, -D switches)
VARIANTS = {
    "first design (64-word chunks, 5 kernels)": (FIRST, {}),
    "K8 (16 or 64-word chunks by the stack, warp writer)": (NEW, {}),
    "16-word chunks, warp writer": (NEW, {"K8_CHUNK_WORDS": 16}),
    "32-word chunks, warp writer": (NEW, {"K8_CHUNK_WORDS": 32}),
    "64-word chunks, warp writer": (NEW, {"K8_CHUNK_WORDS": 64}),
    "16-word chunks, thread writer": (THREAD, {"K8_CHUNK_WORDS": 16}),
    "32-word chunks, thread writer": (THREAD, {"K8_CHUNK_WORDS": 32}),
    "64-word chunks, thread writer": (THREAD, {"K8_CHUNK_WORDS": 64}),
}


def gpu_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def build(nvcc: str, flags: list, names) -> dict:
    """One shared library per variant, all nvcc processes at once."""
    os.makedirs(OUT, exist_ok=True)
    libs, procs = {}, []
    for i, (name, (src, defs)) in enumerate(VARIANTS.items()):
        if name not in names:
            continue
        lib = os.path.join(OUT, f"k8v{i}.so")
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


def first_launcher(lib: str, res, cols: int):
    """A call of the first design on res: its nine scratch tensors and
    five kernels, as its wrapper made them."""
    import torch
    from binary_image_compression_tpu_torch.ops import _cuda, egdevice
    fn = ctypes.CDLL(lib).bic_eg_encode
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    P, rows, nw = res.shape
    dev = res.device
    NC = -(-(rows * nw) // 64)
    NB = -(-NC // 8)
    TW = egdevice.payload_words(rows * cols)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())

    def run():
        words = torch.zeros((P, TW), dtype=torch.int32, device=dev)
        nbits = torch.empty(P, dtype=torch.int64, device=dev)
        i32 = lambda *s: torch.empty(s, dtype=torch.int32, device=dev)
        scratch = [i32(P, NC), i32(P, NC), i32(P, NC, 32), i32(P, NC, 32),
                   i32(P, NB, 32), i32(P, NB, 32), i32(P, NB),
                   torch.empty((P, NB), dtype=torch.int64, device=dev)]
        _cuda.check(fn(ptr(res), *map(ptr, scratch), ptr(words), ptr(nbits),
                       P, rows, cols, nw, NC, NB, TW, _cuda.stream(dev)),
                    "K8 variant")
        return words, nbits
    return run


def new_launcher(lib: str, symbol: str, res, cols: int):
    """A call of the kernel of csrc/eg_encode.cu (or its thread-writer
    variant) on res, as ``egdevice._launch`` makes it: the workspace is
    sized for 16-word chunks, enough for any larger chunk."""
    import torch
    from binary_image_compression_tpu_torch.ops import _cuda, egdevice
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_void_p]
    P, rows, nw = res.shape
    dev = res.device
    TW = egdevice.payload_words(rows * cols)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())

    def run():
        words = torch.zeros((P, TW), dtype=torch.int32, device=dev)
        nbits = torch.empty(P, dtype=torch.int64, device=dev)
        ws = torch.empty(egdevice.workspace_ints(P, rows, nw),
                         dtype=torch.int32, device=dev)
        _cuda.check(fn(ptr(res), ptr(egdevice.step_table(dev)), ptr(ws),
                       ptr(words), ptr(nbits), P, rows, cols, nw, TW,
                       ws.numel(), _cuda.stream(dev)), "K8 variant")
        return words, nbits
    return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="", help="time only the variants "
                    "whose names contain this")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k8_variants: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from binary_image_compression_tpu_torch.models import compress
    from binary_image_compression_tpu_torch.ops import _cuda, egdevice
    from binary_image_compression_tpu_torch.utils import bitplanes, pnm

    gpu = gpu_name()
    print(gpu, flush=True)
    libs = build(_cuda._nvcc(), _cuda.NVCC_FLAGS,
                 [v for v in VARIANTS if args.only in v])
    dev = torch.device("cuda", 0)
    result, wrong = {}, []
    for page, gray in chip_smoke.gray_cases(pnm):
        _, res = chip_smoke.gray_residuals(compress, bitplanes, gray, dev)
        cols = gray.shape[1]
        want = egdevice.eg_encode_plain(res, cols)
        runs = int(egdevice.run_counts(res, cols).sum())
        result[page] = {}
        for name, lib in libs.items():
            src = VARIANTS[name][0]
            run = first_launcher(lib, res, cols) if src == FIRST else \
                new_launcher(lib, "bic_eg_encode_thread" if src == THREAD
                             else "bic_eg_encode", res, cols)
            got = run()
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            if not same:
                wrong.append(f"{name} on {page}")
            parts = chip_smoke.device_split(run, ("k8_", "fill"),
                                            args.reps)
            k8 = sum(v for k, v in parts.items() if "k8_" in k)
            ev = chip_smoke.cuda_ms(run, args.reps)
            result[page][name] = dict(kernels=parts, device_ms=k8,
                                      events_ms=ev, exact=same)
            print(f"{page} ({res.shape[0]} planes, {runs} runs): {name}"
                  f"{'' if same else ' (DIFFERS from eg_encode_plain)'}: "
                  f"device {k8:.4f} ms = " + " + ".join(
                      f"{k} {v:.4f}" for k, v in parts.items())
                  + f"; {ev:.4f} ms per launch (events) [{gpu}]",
                  flush=True)
    print(json.dumps({"gpu": gpu, "k8_variants": result}))
    if wrong:
        print("not exact: " + "; ".join(wrong), file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
