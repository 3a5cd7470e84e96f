"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

At first use, nvcc compiles every ``csrc/*.cu`` for sm_90a, one process per
source, all started together, and links the objects into one shared library
with a plain C interface, ``build/kernels/libbic_kernels.so``, which is
loaded with ctypes.  Each launcher takes its pointers and the CUDA stream
as ``c_void_p``, launches on that stream and returns ``cudaGetLastError()``;
``check`` raises on anything but 0.  Nothing falls back: a missing nvcc, a
failed build or a failed launch raises.

``launches`` counts kernel launches by wrapper name; a wrapper adds one
where it launches its kernel and nowhere else.  ``resolve_device`` turns
the entry points' ``device`` argument into a torch device, refusing CUDA
when there is none.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO = os.path.dirname(_PKG)
CSRC = os.path.join(_PKG, "csrc")
LIB = os.path.join(_REPO, "build", "kernels", "libbic_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

launches: collections.Counter = collections.Counter()

_lib = None
_lock = threading.Lock()


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _newest_source() -> float:
    return max(os.path.getmtime(f) for f in glob.glob(os.path.join(CSRC, "*"))
               if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def build() -> str:
    """Compile csrc/*.cu into LIB, one nvcc per source, all at once, then
    link; returns nvcc's -Xptxas -v report."""
    out = os.path.dirname(LIB)
    os.makedirs(out, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    srcs = _sources()
    objs = [os.path.join(out, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-Xptxas", "-v",
                               "-o", obj, src], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(srcs, objs)]
    try:
        errs = [proc.communicate(timeout=900)[1] for proc in procs]
        failed = [f"{os.path.basename(src)}:\n{err[-4000:]}"
                  for src, err, proc in zip(srcs, errs, procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = f"{LIB}.{tag}.tmp"
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + r.stderr[-4000:])
        os.replace(tmp, LIB)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(errs)


def get_lib() -> ctypes.CDLL:
    """Load the kernel library, building it first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(LIB)
                    or _newest_source() > os.path.getmtime(LIB)):
                build()
            lib = ctypes.CDLL(LIB)
            _declare(lib)
            _lib = lib
    return _lib


def _declare(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bic_fused_search_select.restype = i
    lib.bic_fused_search_select.argtypes = [p, p] + [i] * 16 + [p]
    lib.bic_field_plane.restype = i
    lib.bic_field_plane.argtypes = [p, p] + [i] * 5 + [p]
    lib.bic_decide_modes.restype = i
    lib.bic_decide_modes.argtypes = [p] * 6 + [i] * 7 + [p]
    lib.bic_select_windows.restype = i
    lib.bic_select_windows.argtypes = [p] * 3 + [i] * 16 + [p]
    lib.bic_banded_plane.restype = i
    lib.bic_banded_plane.argtypes = [p, p] + [i] * 5 + [p]
    lib.bic_strict_analyze.restype = i
    lib.bic_strict_analyze.argtypes = [p] * 7 + [i] * 14 + [p]
    lib.bic_packed_dist_matrix.restype = i
    lib.bic_packed_dist_matrix.argtypes = [p] * 3 + [i] * 3 + [p]
    lib.bic_packed_row_weight.restype = i
    lib.bic_packed_row_weight.argtypes = [p] * 2 + [i] * 2 + [p]
    lib.bic_packed_pursuit.restype = i
    lib.bic_packed_pursuit.argtypes = [p] * 5 + [i] * 5 + [p]
    lib.bic_rans_encode.restype = i
    lib.bic_rans_encode.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.bic_eg_encode.restype = i
    lib.bic_eg_encode.argtypes = [p] * 5 + [i] * 5 + [ctypes.c_longlong, p]
    lib.bic_pack_records.restype = i
    lib.bic_pack_records.argtypes = [p] * 8 + [i] * 4 + [p]


def resolve_device(device):
    """The torch device to run on; CUDA requested and absent raises."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available (pass device='cpu' to run the plain "
                           "PyTorch versions)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, as a ctypes pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
