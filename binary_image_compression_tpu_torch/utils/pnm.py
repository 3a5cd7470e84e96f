"""PBM (P4), PGM (P2/P5) and PPM (P6) IO.

Counterpart of ``read_pbm``, ``write_pbm``, ``read_pbm_packed``,
``write_pbm_packed``, ``read_pnm``, ``write_pgm`` and ``write_ppm`` in
``binary_image_compression_tpu/utils/pnm.py``; the PBM writer is
byte-identical with the reference's pbm.cpp:54-77, the P2 writer with
pnm.cpp:110-117.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ..ops import bitpack


def _read_token(f) -> bytes:
    """Read one whitespace-delimited token, skipping '#' comments."""
    tok = b""
    while True:
        c = f.read(1)
        if not c:
            break
        if c == b"#":
            f.readline()
            continue
        if c.isspace():
            if tok:
                break
            continue
        tok += c
    return tok


def read_pbm(path_or_file) -> np.ndarray:
    """Read a P4 PBM into bool [rows, cols] (1 = black, as in the raster)."""
    f = open(path_or_file, "rb") if not hasattr(path_or_file, "read") \
        else path_or_file
    try:
        magic = f.read(2)
        if magic != b"P4":
            raise ValueError(f"not a P4 PBM: magic={magic!r}")
        cols = int(_read_token(f))
        rows = int(_read_token(f))
        bpr = (cols + 7) // 8
        raster = np.frombuffer(f.read(bpr * rows), dtype=np.uint8)
        if raster.size < bpr * rows:
            raise ValueError("truncated PBM raster")
        bits = np.unpackbits(raster.reshape(rows, bpr), axis=1)
        return bits[:, :cols].astype(bool)
    finally:
        if f is not path_or_file:
            f.close()


def write_pbm(bits: np.ndarray, path_or_file) -> None:
    """Write bool [rows, cols] as P4 (pbm.cpp:54-77)."""
    bits = np.asarray(bits, dtype=bool)
    rows, cols = bits.shape
    data = f"P4\n{cols} {rows}\n".encode() + np.packbits(bits, axis=1).tobytes()
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "wb") as f:
            f.write(data)


def read_pbm_packed(path_or_file):
    """Read a PBM directly into (uint32 packed [rows, w], rows, cols)."""
    bits = read_pbm(path_or_file)
    return bitpack.np_pack(bits), bits.shape[0], bits.shape[1]


def write_pbm_packed(packed, cols: int, path_or_file) -> None:
    """Write packed rows [rows, nwords(cols)] as P4: uint32 words (numpy),
    or a torch tensor of words on any device (int64 values or int32 bit
    patterns)."""
    if isinstance(packed, torch.Tensor):
        bits = bitpack.unpack(packed, cols).cpu().numpy()
    else:
        bits = bitpack.np_unpack(np.asarray(packed), cols)
    write_pbm(bits, path_or_file)


def _write(data: bytes, path_or_file) -> None:
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        with open(path_or_file, "wb") as f:
            f.write(data)


def read_pnm(path_or_file):
    """Read a P2/P5 PGM or a P6 PPM: (uint32 [rows, cols], maxval), a PPM's
    pixels packed 0xRRGGBB (the reference's pixel_t, pnm.cpp:214)."""
    f = open(path_or_file, "rb") if not hasattr(path_or_file, "read") \
        else path_or_file
    try:
        magic = f.read(2)
        if magic not in (b"P2", b"P5", b"P6"):
            raise ValueError(f"unsupported PNM magic {magic!r}")
        cols = int(_read_token(f))
        rows = int(_read_token(f))
        maxval = int(_read_token(f))
        n = rows * cols
        if magic == b"P2":
            data = np.array(f.read().split()[:n], dtype=np.uint32)
            return data.reshape(rows, cols), maxval
        if magic == b"P5":
            if maxval < 256:
                raw = np.frombuffer(f.read(n), dtype=np.uint8)
            else:
                raw = np.frombuffer(f.read(2 * n), dtype=">u2")
            return raw.astype(np.uint32).reshape(rows, cols), maxval
        raw = np.frombuffer(f.read(3 * n), dtype=np.uint8).reshape(rows, cols,
                                                                   3)
        packed = ((raw[..., 0].astype(np.uint32) << 16)
                  | (raw[..., 1].astype(np.uint32) << 8)
                  | raw[..., 2].astype(np.uint32))
        return packed, maxval
    finally:
        if f is not path_or_file:
            f.close()


def write_pgm(img: np.ndarray, maxval: int, path_or_file, *,
              binary: bool = True) -> None:
    """Write a PGM: P5 (one byte a pixel, or big-endian 16 bits when
    maxval >= 256) or, binary=False, the reference's tab-separated P2 with
    a newline after every 20 values."""
    img = np.asarray(img)
    rows, cols = img.shape
    header = (b"P5" if binary else b"P2") \
        + f"\n{cols} {rows}\n{maxval}\n".encode()
    if binary:
        payload = (img.astype(np.uint8).tobytes() if maxval < 256
                   else img.astype(">u2").tobytes())
    else:
        buf = io.StringIO()
        for i, v in enumerate(img.ravel()):
            buf.write(f"{int(v)}\t")
            if (i + 1) % 20 == 0:
                buf.write("\n")
        payload = buf.getvalue().encode()
    _write(header + payload, path_or_file)


def write_ppm(img_rgb_packed: np.ndarray, maxval: int, path_or_file) -> None:
    """Write 0xRRGGBB-packed uint32 [rows, cols] as binary P6 (pnm.cpp:224)."""
    img = np.asarray(img_rgb_packed, dtype=np.uint32)
    rows, cols = img.shape
    rgb = np.stack([(img >> 16) & 0xFF, (img >> 8) & 0xFF, img & 0xFF],
                   axis=-1).astype(np.uint8)
    _write(f"P6\n{cols} {rows}\n{maxval}\n".encode() + rgb.tobytes(),
           path_or_file)
