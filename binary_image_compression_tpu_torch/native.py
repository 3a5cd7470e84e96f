"""ctypes bridge to the C++ bitstream runtime (``native/bic_native.cpp``).

Counterpart of ``binary_image_compression_tpu/native.py``, bound to the same
source file but built into ``build/native/`` so the reference package's own
library is left alone.  Bound: the windowed codecs' entry points (record
packer, the fused mode decision and record packer of codecs 4/7/8
``bic_decide_pack``, windowed decoder and host encoder, enumerative
widths), codec 12's context-adaptive coder (``bic_cabic_encode``,
``bic_cabic_decode``), codec 13's
(``bic_scab_encode``, ``bic_scab_decode``, ``bic_scab_rans_decode``) and
codec 10's adaptive exp-Golomb run coder (``bic_eg_encode_runs``,
``bic_eg_decode_runs``).
Unlike the reference bridge there is no pure-Python fallback: a failed
build, load or call raises, and a decoder that rejects its stream raises
``ValueError``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_REPO, "native", "bic_native.cpp")
LIB = os.path.join(_REPO, "build", "native", "libbic_native.so")

_lib = None
_lock = threading.Lock()


def build() -> None:
    """Compile ``bic_native.cpp`` with g++ (atomic rename into place, so
    processes building at the same time never load a half-written
    library)."""
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    r = subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-o", tmp, SRC], capture_output=True, text=True,
                       timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"building {SRC} failed:\n{r.stderr[-4000:]}")
    os.replace(tmp, LIB)


def get_lib() -> ctypes.CDLL:
    """Load the native library, building it first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if (not os.path.exists(LIB)
                    or os.path.getmtime(SRC) > os.path.getmtime(LIB)):
                build()
            lib = ctypes.CDLL(LIB)
            _declare(lib)
            _lib = lib
    return _lib


def _declare(lib) -> None:
    lib.bic_pack_tiles.restype = ctypes.c_long
    lib.bic_pack_tiles.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.bic_decide_pack.restype = ctypes.c_long
    lib.bic_decide_pack.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int32)]
    lib.bic_cabic_encode.restype = ctypes.c_long
    lib.bic_cabic_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.bic_cabic_decode.restype = ctypes.c_int
    lib.bic_cabic_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.bic_decode_windowed.restype = ctypes.c_int
    lib.bic_decode_windowed.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint8)]
    lib.bic_enum_nbits.restype = ctypes.c_int
    lib.bic_enum_nbits.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.bic_encode_windowed.restype = ctypes.c_long
    lib.bic_encode_windowed.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.bic_scab_encode.restype = ctypes.c_long
    lib.bic_scab_encode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_long]
    lib.bic_eg_encode_runs.restype = ctypes.c_long
    lib.bic_eg_encode_runs.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
    lib.bic_eg_decode_runs.restype = ctypes.c_int
    lib.bic_eg_decode_runs.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_uint8)]
    for name in ("bic_scab_decode", "bic_scab_rans_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pack_tiles(header: bytes, M: int, mode, inv, rank, idx_len, weight,
               residual_bits) -> bytes:
    """Pack decided tile records after the header (``bic_pack_tiles``).

    residual_bits: 0/1 [T, M] of each tile's chosen residual."""
    lib = get_lib()
    n = len(mode)
    mode = np.ascontiguousarray(mode, dtype=np.int32)
    inv = np.ascontiguousarray(inv, dtype=np.uint8)
    rank = np.ascontiguousarray(rank, dtype=np.int64)
    idx_len = np.ascontiguousarray(idx_len, dtype=np.int32)
    weight = np.ascontiguousarray(weight, dtype=np.int32)
    res = np.ascontiguousarray(residual_bits, dtype=np.uint8).reshape(n, M)
    cap = len(header) + n * (M // 2 + 64) + 1024  # generous upper bound
    out = np.zeros(cap, dtype=np.uint8)
    ln = lib.bic_pack_tiles(header, len(header), n, M,
                            _p(mode, ctypes.c_int32), _p(inv, ctypes.c_uint8),
                            _p(rank, ctypes.c_int64),
                            _p(idx_len, ctypes.c_int32),
                            _p(weight, ctypes.c_int32),
                            _p(res, ctypes.c_uint8),
                            _p(out, ctypes.c_uint8), cap)
    if ln < 0:
        raise RuntimeError(f"bic_pack_tiles overflowed its {cap} B buffer")
    return out[:ln].tobytes()


def decide_pack(header: bytes, M: int, codec_id: int, weights4, has_cands,
                idx_len, inv, rank, residual4) -> tuple[bytes, np.ndarray]:
    """The mode decision (two adaptive Golomb contexts) and the record
    packing of codec 4, 7 or 8 in one call (``bic_decide_pack``).

    The arrays are one page's ``compress.encode_analyze`` output, [T, ...];
    residual4 is the uint32 [T, 4, nwords] bank of the four candidate
    residuals.  Returns (the stream, int32 [T] the mode of each tile)."""
    lib = get_lib()
    w4 = np.ascontiguousarray(weights4, dtype=np.int32)
    n = w4.shape[0]
    hc = np.ascontiguousarray(has_cands, dtype=np.uint8)
    il = np.ascontiguousarray(idx_len, dtype=np.int32)
    iv = np.ascontiguousarray(inv, dtype=np.uint8)
    rk = np.ascontiguousarray(rank, dtype=np.int64)
    r4 = np.ascontiguousarray(residual4, dtype=np.uint32)
    if w4.shape != (n, 4) or r4.shape[:2] != (n, 4) or not all(
            a.shape == (n,) for a in (hc, il, iv, rk)):
        raise ValueError("decide_pack takes [T, 4] weights, [T, 4, nwords] "
                         "residuals and [T] per-tile fields")
    cap = len(header) + n * (M // 2 + 64) + 1024  # generous upper bound
    out = np.zeros(cap, dtype=np.uint8)
    mode = np.zeros(n, dtype=np.int32)
    ln = lib.bic_decide_pack(header, len(header), n, M, codec_id,
                             _p(w4, ctypes.c_int32), _p(hc, ctypes.c_uint8),
                             _p(il, ctypes.c_int32), _p(iv, ctypes.c_uint8),
                             _p(rk, ctypes.c_int64), _p(r4, ctypes.c_uint32),
                             r4.shape[-1], _p(out, ctypes.c_uint8), cap,
                             _p(mode, ctypes.c_int32))
    if ln < 0:
        raise RuntimeError(f"bic_decide_pack failed (rc={ln}): M={M} with "
                           f"{r4.shape[-1]} residual words, or a {cap} B "
                           f"buffer overflow")
    return out[:ln].tobytes(), mode


def decode_windowed(blob: bytes, rows: int, cols: int) -> np.ndarray:
    """Decode a codec 4/6/7/8 BIC1 stream to bool [rows, cols]."""
    lib = get_lib()
    out = np.zeros(rows * cols, dtype=np.uint8)
    rc = lib.bic_decode_windowed(blob, len(blob), _p(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"bic_decode_windowed rejected the stream (rc={rc})")
    return out.reshape(rows, cols).astype(bool)


def enum_nbits(n: int, w: int) -> int:
    """ceil(log2 C(n, w)): the enumerative rank width (``bic_enum_nbits``)."""
    return int(get_lib().bic_enum_nbits(n, w))


def encode_windowed(img: np.ndarray, header: bytes, codec_id: int,
                    strict: bool, W: int, T: int, R: int) -> bytes:
    """The host encoder for codecs 4/6/7/8 (``bic_encode_windowed``)."""
    lib = get_lib()
    img = np.ascontiguousarray(img, dtype=np.uint8)
    rows, cols = img.shape
    cap = rows * cols + 65536
    out = np.zeros(cap, dtype=np.uint8)
    n = lib.bic_encode_windowed(_p(img, ctypes.c_uint8), header, len(header),
                                codec_id, int(strict), W, rows, cols, T, R,
                                _p(out, ctypes.c_uint8), cap)
    if n <= 0:
        raise RuntimeError(f"bic_encode_windowed failed (rc={n})")
    return out[:n].tobytes()


def cabic_encode(img_u8: np.ndarray) -> bytes:
    """Codec 12's payload (``bic_cabic_encode``): 10-bit causal-template
    context-adaptive binary range coding of the page."""
    lib = get_lib()
    img_u8 = np.ascontiguousarray(img_u8, dtype=np.uint8)
    rows, cols = img_u8.shape
    cap = rows * cols + 4096
    out = np.zeros(cap, dtype=np.uint8)
    n = lib.bic_cabic_encode(_p(img_u8, ctypes.c_uint8), rows, cols,
                             _p(out, ctypes.c_uint8), cap)
    if n < 0:
        raise RuntimeError(f"bic_cabic_encode overflowed its {cap} B "
                           f"buffer (rc={n})")
    return out[:n].tobytes()


def cabic_decode(body: bytes, rows: int, cols: int) -> np.ndarray:
    """Decode a codec-12 payload (``bic_cabic_decode``) to bool
    [rows, cols]."""
    out = np.zeros(rows * cols, dtype=np.uint8)
    rc = get_lib().bic_cabic_decode(body, len(body), rows, cols,
                                    _p(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"bic_cabic_decode rejected the codec-12 payload "
                         f"(rc={rc})")
    return out.reshape(rows, cols).astype(bool)


def scab_encode(img_u8: np.ndarray, tmpl: int, n_stripes: int, *,
                ramp: bool = True, ctx_pre: np.ndarray | None = None
                ) -> bytes:
    """Codec-13 mode-0/1 payload (``bic_scab_encode``): stripe-parallel
    context-adaptive range coding.  ctx_pre, uint16 [rows, cols], is a
    precomputed context map (``compress.scab_ctx_map``); it must equal
    the coder's own scan."""
    lib = get_lib()
    img_u8 = np.ascontiguousarray(img_u8, dtype=np.uint8)
    rows, cols = img_u8.shape
    cp = None
    if ctx_pre is not None:
        ctx_pre = np.ascontiguousarray(ctx_pre, dtype=np.uint16)
        if ctx_pre.shape != (rows, cols):
            raise ValueError(f"ctx_pre is {ctx_pre.shape}, the page "
                             f"{(rows, cols)}")
        cp = _p(ctx_pre, ctypes.c_uint16)
    cap = rows * cols + 4 * n_stripes + 4096
    out = np.zeros(cap, dtype=np.uint8)
    n = lib.bic_scab_encode(_p(img_u8, ctypes.c_uint8), rows, cols, tmpl,
                            n_stripes, int(ramp), cp, _p(out, ctypes.c_uint8),
                            cap)
    if n < 0:
        raise RuntimeError(f"bic_scab_encode failed (rc={n})")
    return out[:n].tobytes()


def _scab_decode(name: str, body: bytes, rows: int, cols: int) -> np.ndarray:
    out = np.zeros(rows * cols, dtype=np.uint8)
    rc = getattr(get_lib(), name)(body, len(body), rows, cols,
                                  _p(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"{name} rejected the codec-13 payload (rc={rc})")
    return out.reshape(rows, cols).astype(bool)


def scab_decode(body: bytes, rows: int, cols: int) -> np.ndarray:
    """Decode a codec-13 mode-0/1 payload (``bic_scab_decode``)."""
    return _scab_decode("bic_scab_decode", body, rows, cols)


def scab_rans_decode(body: bytes, rows: int, cols: int) -> np.ndarray:
    """Decode a codec-13 mode-2 payload (``bic_scab_rans_decode``)."""
    return _scab_decode("bic_scab_rans_decode", body, rows, cols)


def eg_encode_runs(runs: np.ndarray) -> bytes:
    """Codec 10's payload (``bic_eg_encode_runs``): the adaptive
    exp-Golomb codes of the zero-run lengths, MSB-first, byte-aligned."""
    lib = get_lib()
    runs = np.ascontiguousarray(runs, dtype=np.int64)
    cap = int(runs.sum()) // 4 + 8 * len(runs) + 4096
    out = np.zeros(cap, dtype=np.uint8)
    n = lib.bic_eg_encode_runs(_p(runs, ctypes.c_int64), len(runs),
                               _p(out, ctypes.c_uint8), cap)
    if n < 0:
        raise ValueError(f"bic_eg_encode_runs failed (rc={n}): a negative "
                         f"run or a {cap} B buffer overflow")
    return out[:n].tobytes()


def eg_decode_runs(payload: bytes, n_pixels: int) -> np.ndarray:
    """Decode a codec-10 payload (``bic_eg_decode_runs``) to the flat 0/1
    uint8 residual of `n_pixels` pixels."""
    out = np.zeros(n_pixels, dtype=np.uint8)
    rc = get_lib().bic_eg_decode_runs(payload, len(payload), n_pixels,
                                      _p(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError(f"bic_eg_decode_runs rejected the codec-10 payload "
                         f"(rc={rc})")
    return out
