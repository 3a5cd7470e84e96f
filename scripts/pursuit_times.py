"""Time the port's BSVD pursuit on one card: an A/B of two checkouts, and
the pursuit kernel's variants.

    python3 scripts/pursuit_times.py [--repo DIR] [--reps N]
    python3 scripts/pursuit_times.py --ab PARENT_DIR [--reps N]
    python3 scripts/pursuit_times.py --variants

With ``--repo`` (this checkout by default): imports
``binary_image_compression_tpu_torch`` from DIR and, after one warm-up each,
times N learns of doc512 (W=16, random-centroid init, seed 34503498) at
K = 64 and at K = 512, with a synchronised timer around
``bsvd.update_coefficients`` (the pursuit ms per learn, whatever route the
checkout's packed pursuit takes), and N codec-11 encodes of doc512
(``codec.encode``, host clock).  Prints the card's name and power limit and
one JSON line, in ms.

With ``--ab PARENT_DIR``: runs the above as four processes, PARENT_DIR,
this checkout, this checkout, PARENT_DIR, and prints each side's medians
and one JSON line with every time.

With ``--variants``: builds ``scripts/pursuit_variants.cu`` (the kernel at
16 and 8 lanes a row) beside the kernels and times, by torch.profiler's
device time, the library's kernel (a warp a row) and both variants, each
with the dictionary staged in shared memory and read from device memory,
on three inputs: the first ``update_coefficients`` call of a doc512 learn
at K = 64 and at K = 512, and chip_smoke's planted letter page (33,120 rows
of 256 bits, K = 512).  Every variant must equal the library's kernel.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOC = os.path.join(HERE, "tests", "fixtures", "doc512.pbm")


def gpu_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def times(repo: str, reps: int) -> dict:
    """Pursuit ms per learn at K = 64 and 512 and the codec-11 encode of the
    checkout `repo`."""
    import torch
    sys.path.insert(0, os.path.abspath(repo))
    from binary_image_compression_tpu_torch.models import bsvd, codec
    from binary_image_compression_tpu_torch.utils import pnm

    dev = torch.device("cuda", 0)
    doc = pnm.read_pbm(DOC)
    X = bsvd.patchify_to_rows(torch.from_numpy(doc).to(dev), 16)
    orig = bsvd.update_coefficients
    spent = [0.0]

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = orig(*a, **k)
        torch.cuda.synchronize()
        spent[0] += (time.perf_counter() - t0) * 1e3
        return r

    out = {"repo": os.path.abspath(repo)}
    bsvd.update_coefficients = timed
    try:
        for K in (64, 512):
            bsvd.learn(X, K=K, init="random_centroids")
            runs = []
            for _ in range(reps):
                spent[0] = 0.0
                bsvd.learn(X, K=K, init="random_centroids")
                runs.append(spent[0])
            out[f"pursuit_ms_k{K}"] = runs
    finally:
        bsvd.update_coefficients = orig
    p = codec.CodecParams(codec=11, W=16, T=0, R=0)
    blob = codec.encode(doc, p, device="cuda")
    enc = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codec.encode(doc, p, device="cuda")
        torch.cuda.synchronize()
        enc.append((time.perf_counter() - t0) * 1e3)
    out.update(bytes=len(blob), encode_ms=enc)
    return out


def ab(parent: str, reps: int) -> None:
    """parent / change / change / parent, one process each."""
    sides = {"parent": [], "change": []}
    for side, repo in (("parent", parent), ("change", HERE),
                       ("change", HERE), ("parent", parent)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--repo", repo, "--reps", str(reps)],
                           capture_output=True, text=True, timeout=1800)
        if r.returncode != 0:
            raise RuntimeError(f"{side} ({repo}) failed:\n{r.stderr[-3000:]}")
        sides[side].append(json.loads(r.stdout.strip().splitlines()[-1]))
    summary = {}
    for side, runs in sides.items():
        summary[side] = {k: [x for r in runs for x in r[k]]
                         for k in ("pursuit_ms_k64", "pursuit_ms_k512",
                                   "encode_ms")}
        summary[side]["bytes"] = runs[0]["bytes"]
        print(f"{side}: " + ", ".join(
            f"{k} median {float(np.median(v)):.3f} (quartiles "
            f"{float(np.percentile(v, 25)):.3f}-"
            f"{float(np.percentile(v, 75)):.3f})"
            for k, v in summary[side].items() if k != "bytes")
            + f", {summary[side]['bytes']} B")
    print(json.dumps(summary))


def build_variants():
    from binary_image_compression_tpu_torch.ops import _cuda
    out = os.path.join(HERE, "build", "pursuit_variants")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libpursuit_variants.so")
    src = os.path.join(HERE, "scripts", "pursuit_variants.cu")
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-I",
                        _cuda.CSRC, "-o", lib, src], capture_output=True,
                       text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr[-3000:]}")
    lib = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    for g in (16, 8):
        fn = getattr(lib, f"bic_packed_pursuit_g{g}")
        fn.restype = i
        fn.argtypes = [p] * 5 + [i] * 5 + [p]
    return lib


def variants() -> None:
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from binary_image_compression_tpu_torch.models import bsvd
    from binary_image_compression_tpu_torch.ops import _cuda
    from binary_image_compression_tpu_torch.ops import packed_dist as pd
    from binary_image_compression_tpu_torch.utils import pnm

    dev = torch.device("cuda", 0)
    _cuda.get_lib()
    lib = build_variants()

    def launcher(g, stage):
        if g == 32:
            return lambda Ep, Dp, A, K: pd._launch_pursuit(Ep, Dp, A, K,
                                                           stage=stage)
        fn = getattr(lib, f"bic_packed_pursuit_g{g}")

        def launch(Ep, Dp, A, K):
            N, nw = Ep.shape
            passes = torch.empty((N,), dtype=torch.int32, device=dev)
            ctr = torch.empty((2,), dtype=torch.int64, device=dev)
            _cuda.check(fn(*(ctypes.c_void_p(t.data_ptr())
                             for t in (Ep, Dp, A, passes, ctr)),
                           N, K, nw, K, stage, _cuda.stream(dev)),
                        f"bic_packed_pursuit_g{g}")
            return ctr[1], passes
        return launch

    X = bsvd.patchify_to_rows(torch.from_numpy(pnm.read_pbm(DOC)).to(dev),
                              16)
    inputs = []
    for K in (64, 512):
        E, D, A = cs.first_pursuit_inputs(
            bsvd, lambda: bsvd.learn(X, K=K, init="random_centroids",
                                     max_iters=1))
        inputs.append((f"doc512 K={K}", bsvd._pack(E), bsvd._pack(D),
                       A.contiguous()))
    N, M, K = cs.LETTER_PURSUIT
    E, D, A = cs.planted_pursuit(N, M, K, N, dev)
    inputs.append(("planted letter page", bsvd._pack(E), bsvd._pack(D), A))
    gpu = gpu_name()
    print(gpu)
    table = {}
    for name, Ep0, Dp, A0 in inputs:
        K = Dp.shape[0]
        ref_E, ref_A = Ep0.clone(), A0.clone()
        ref = pd._launch_pursuit(ref_E, Dp, ref_A, K)
        for g in (32, 16, 8):
            for stage in (1, 0):
                launch = launcher(g, stage)
                Eg, Ag = Ep0.clone(), A0.clone()
                got = launch(Eg, Dp, Ag, K)
                torch.cuda.synchronize()
                if not (torch.equal(Eg, ref_E) and torch.equal(Ag, ref_A)
                        and torch.equal(got[1], ref[1])
                        and int(got[0]) == int(ref[0])):
                    raise AssertionError(f"variant G={g} stage={stage} != "
                                         f"the kernel on {name}")
                ms = []
                for _ in range(3):
                    copies = iter([(Ep0.clone(), A0.clone())
                                   for _ in range(11)])

                    def one():
                        e, a = next(copies)
                        return launch(e, Dp, a, K)
                    ms.append(cs.device_ms(one, "packed_pursuit_kernel", 10))
                key = f"{name}, G={g}, D {'shared' if stage else 'L2'}"
                table[key] = ms
                print(f"{key}: device ms {cs.fmt(ms)} [{gpu}]", flush=True)
    print(json.dumps({"gpu": gpu, "device_ms": table}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ab", metavar="PARENT_DIR")
    ap.add_argument("--variants", action="store_true")
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("pursuit_times: torch.cuda is not available", file=sys.stderr)
        return 1
    if a.variants:
        variants()
    elif a.ab:
        print(gpu_name())
        ab(a.ab, a.reps)
    else:
        print(gpu_name())
        print(json.dumps(times(a.repo, a.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
