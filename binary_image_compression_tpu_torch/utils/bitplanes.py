"""Grayscale <-> bitplanes (the reference's bitplane_tool / plane2pgm_tool).

Counterpart of ``binary_image_compression_tpu/utils/bitplanes.py``:
``nplanes_for_maxval``, ``decompose`` and ``recompose`` as numpy, and
``decompose_packed`` / ``recompose_packed`` as torch ops on packed words
(int32 bit patterns, the port's kernel layout).  Plane b holds bit b of
every pixel, LSB plane first; a maxval takes the planes b = 1, 2, 4, ...
below it (bitplane_tool.cpp:24-39).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bitpack


def nplanes_for_maxval(maxval: int) -> int:
    """Planes the reference tool emits: #{b = 1, 2, 4, ... : b < maxval}."""
    n = 0
    b = 1
    while b < maxval:
        n += 1
        b <<= 1
    return n


def decompose(gray: np.ndarray, maxval: int) -> np.ndarray:
    """uint [rows, cols] -> bool [nplanes, rows, cols], LSB plane first."""
    gray = np.asarray(gray, dtype=np.uint32)
    n = nplanes_for_maxval(maxval)
    shifts = np.arange(n, dtype=np.uint32).reshape(-1, 1, 1)
    return ((gray[None] >> shifts) & 1).astype(bool)


def recompose(planes: np.ndarray) -> np.ndarray:
    """bool [nplanes, rows, cols] -> uint32 [rows, cols] (LSB plane first)."""
    planes = np.asarray(planes)
    shifts = np.arange(planes.shape[0], dtype=np.uint32).reshape(-1, 1, 1)
    return (planes.astype(np.uint32) << shifts).sum(axis=0, dtype=np.uint32)


def decompose_packed(gray: torch.Tensor, maxval: int) -> torch.Tensor:
    """Integer gray [rows, cols] (values < 2^31) -> packed planes int32
    [n, rows, nwords(cols)]."""
    n = nplanes_for_maxval(maxval)
    shifts = torch.arange(n, device=gray.device).reshape(-1, 1, 1)
    bits = (gray.to(torch.int64)[None] >> shifts) & 1
    return bitpack.to_i32(bitpack.pack(bits))


def recompose_packed(planes_packed: torch.Tensor, cols: int) -> torch.Tensor:
    """Packed planes [n, rows, w] (int32 bit patterns or int64 values) ->
    int64 gray [rows, cols]."""
    bits = bitpack.unpack(planes_packed, cols).to(torch.int64)
    shifts = torch.arange(bits.shape[0], device=bits.device).reshape(-1, 1, 1)
    return (bits << shifts).sum(dim=0)
