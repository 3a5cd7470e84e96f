"""MSB-first 32-bit packed bit rows, in torch and numpy.

Counterpart of ``binary_image_compression_tpu/ops/bitpack.py`` (``nwords``,
``pack``, ``unpack``, ``patchify``, ``np_pack``, ``np_unpack``).  Bit j of a row lands in
word j // 32 at bit 31 - j % 32, so serialized big-endian words are PBM P4
raster bytes.

torch has no popcount and, on the CPU, no shifts or min on uint32, so torch
words are carried as int64 holding the uint32 value (0 <= w < 2**32).  At a
kernel boundary they cross as int32 tensors holding the same bit pattern
(``to_i32`` / ``from_i32``).
"""

from __future__ import annotations

import numpy as np
import torch

LANE = 32
U32 = 0xFFFFFFFF


def nwords(cols: int) -> int:
    """Number of 32-bit words needed for `cols` bits."""
    return -(-cols // LANE)


def _shifts(device) -> torch.Tensor:
    return torch.arange(LANE - 1, -1, -1, dtype=torch.int64, device=device)


def pack(bits: torch.Tensor) -> torch.Tensor:
    """0/1 [..., cols] -> int64 words [..., nwords(cols)] (uint32 values)."""
    cols = bits.shape[-1]
    w = nwords(cols)
    pad = w * LANE - cols
    b = bits.to(torch.int64)
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(b.shape[:-1] + (w, LANE))
    return (b << _shifts(b.device)).sum(dim=-1)


def unpack(packed: torch.Tensor, cols: int) -> torch.Tensor:
    """Words [..., w] (int64 values or int32 bit patterns) -> bool [..., cols]."""
    x = packed.to(torch.int64) & U32
    bits = (x.unsqueeze(-1) >> _shifts(x.device)) & 1
    bits = bits.reshape(x.shape[:-1] + (x.shape[-1] * LANE,))
    return bits[..., :cols].to(torch.bool)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the low 32 bits of an int64 tensor (int64 result)."""
    x = x & U32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def med_fields(q: torch.Tensor, wmask: int) -> torch.Tensor:
    """MED residual on [..., W] W-bit row fields (bit W-1-c = column c):
    each pixel XOR its up, left and up-left neighbours, zero outside."""
    up = torch.nn.functional.pad(q, (1, 0))[..., :-1]
    return (q ^ up ^ (q >> 1) ^ (up >> 1)) & wmask


def fields_to_words(fields: torch.Tensor, W: int) -> torch.Tensor:
    """[..., W] W-bit row fields (int64 values or int32 bit patterns) ->
    int64 words [..., nwords(W*W)] of the row-major W x W bits (any W,
    including W = 24, whose fields straddle words)."""
    shifts = torch.arange(W - 1, -1, -1, device=fields.device)
    bits = (fields.to(torch.int64)[..., None] >> shifts) & 1
    return pack(bits.reshape(fields.shape[:-1] + (W * W,)))


def patchify(img_bits: torch.Tensor, W: int) -> torch.Tensor:
    """[..., rows, cols] -> [..., Ny*Nx, W, W] tile grid in raster order,
    rows and cols padded with zeros up to multiples of W (JAX
    ``bitpack.patchify``)."""
    rows, cols = img_bits.shape[-2:]
    ny, nx = -(-rows // W), -(-cols // W)
    pr, pc = ny * W - rows, nx * W - cols
    if pr or pc:
        img_bits = torch.nn.functional.pad(img_bits, (0, pc, 0, pr))
    lead = img_bits.shape[:-2]
    t = img_bits.reshape(lead + (ny, W, nx, W)).transpose(-3, -2)
    return t.reshape(lead + (ny * nx, W, W))


def to_i32(words: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> int32 tensor with the same bit pattern."""
    w = words.to(torch.int64) & U32
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def from_i32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 uint32 values."""
    return words.to(torch.int64) & U32


def np_pack(bits: np.ndarray) -> np.ndarray:
    """numpy twin of ``pack``: bool [..., cols] -> uint32 [..., nwords]."""
    bits = np.asarray(bits, dtype=np.uint8)
    cols = bits.shape[-1]
    w = nwords(cols)
    pad = w * LANE - cols
    if pad:
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    by = np.packbits(bits, axis=-1)  # MSB-first bytes
    by = by.reshape(by.shape[:-1] + (w, 4)).astype(np.uint32)
    return ((by[..., 0] << 24) | (by[..., 1] << 16) | (by[..., 2] << 8)
            | by[..., 3])


def np_unpack(packed: np.ndarray, cols: int) -> np.ndarray:
    """numpy twin of ``unpack``: uint32 [..., w] -> bool [..., cols]."""
    packed = np.asarray(packed, dtype=np.uint32)
    by = np.stack([(packed >> s) & 0xFF for s in (24, 16, 8, 0)], axis=-1)
    by = by.astype(np.uint8).reshape(packed.shape[:-1]
                                     + (packed.shape[-1] * 4,))
    return np.unpackbits(by, axis=-1)[..., :cols].astype(bool)
