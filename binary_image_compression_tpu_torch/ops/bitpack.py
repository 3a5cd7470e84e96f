"""MSB-first 32-bit packed bit rows, in torch and numpy.

Counterpart of ``binary_image_compression_tpu/ops/bitpack.py``: packing
(``nwords``, ``pack``, ``unpack``, ``trail_mask``, ``np_pack``,
``np_unpack``), the elementwise GF(2) ops, the popcount reductions, the
GF(2) products and the structural ops (reference binmat.cpp), under JAX's
names and argument orders.  Bit j of a row lands in word j // 32 at bit
31 - j % 32, so serialized big-endian words are PBM P4 raster bytes.

torch has no popcount and, on the CPU, no shifts or min on uint32, so torch
words are carried as int64 holding the uint32 value (0 <= w < 2**32).  At a
kernel boundary they cross as int32 tensors holding the same bit pattern
(``to_i32`` / ``from_i32``).  The functions take either form and return
int64 words; counts come back as int32 tensors, as in JAX.

``row_weight`` (and ``weight``, ``gf2_sum``, ``row_sum`` on top of it) runs
kernel K6 and ``dist_matrix`` kernel K5 (``ops/packed_dist``): on a CUDA
tensor they launch the kernel, on a CPU tensor its plain version.  ``mul``
and ``and_counts`` are float32 products of 0/1 matrices, exact below 2**24,
as JAX computes them outside any Pallas kernel.
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


def trail_mask(cols: int, device=None) -> torch.Tensor:
    """int32 [nwords(cols)]: the bits of each word that lie inside a row
    (the ragged last word's low bits are 0; reference binmat.cpp:140-161)."""
    m = [-1] * nwords(cols)
    if cols % LANE:
        v = (U32 << (LANE - cols % LANE)) & U32
        m[-1] = v - (1 << 32) if v >= 1 << 31 else v
    return torch.tensor(m, dtype=torch.int32, device=device)


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
    """int32 bit patterns (or int64 values) -> int64 uint32 values."""
    return words.to(torch.int64) & U32


# --- elementwise GF(2) ops (binmat.cpp:463-496) ----------------------------

def xor(a, b):
    """GF(2) addition, the reference's ``add`` / ``bool_xor``."""
    return from_i32(a) ^ from_i32(b)


add = xor  # reference naming (binmat.h:164)


def bool_and(a, b):
    return from_i32(a) & from_i32(b)


def bool_or(a, b):
    return from_i32(a) | from_i32(b)


def flip(packed, cols: int):
    """Complement every bit inside the row; the padding keeps its bits
    (binmat.cpp:174-178)."""
    return from_i32(packed) ^ from_i32(trail_mask(cols, packed.device))


# --- popcount reductions (binmat.cpp:22-126) -------------------------------

def row_weight(packed) -> torch.Tensor:
    """[..., rows] ones per row, padding bits included (binmat.cpp:66-76):
    kernel K6 on the rows."""
    from . import packed_dist
    lead, w = packed.shape[:-1], packed.shape[-1]
    rows = to_i32(packed.reshape(-1, w))
    return packed_dist.packed_row_weight(rows).reshape(lead)


def weight(packed) -> torch.Tensor:
    """Number of set bits of each [rows, w] matrix (binmat.cpp:57)."""
    return row_weight(packed).sum(dim=-1, dtype=torch.int32)


def col_weight(packed, cols: int) -> torch.Tensor:
    """[..., cols] ones per column (exact; the reference undercounts,
    binmat.cpp:87)."""
    return unpack(packed, cols).sum(dim=-2, dtype=torch.int32)


def gf2_sum(packed) -> torch.Tensor:
    """Parity of all bits (the reference's ``sum()``, binmat.cpp:95)."""
    return weight(packed) & 1


def row_sum(packed) -> torch.Tensor:
    """Per-row parity (binmat.cpp:99-110)."""
    return row_weight(packed) & 1


def col_sum(packed) -> torch.Tensor:
    """Per-column parity as a packed 1-row matrix [..., 1, w], padding bits
    included (binmat.cpp:113-126).  torch has no XOR reduction: the parity
    of the column counts, repacked."""
    w = packed.shape[-1]
    odd = unpack(packed, w * LANE).sum(dim=-2, keepdim=True) & 1
    return pack(odd)


def dist(a, b) -> torch.Tensor:
    """Hamming distance |a ^ b| (binmat.cpp:499-512)."""
    return weight(xor(a, b))


# --- GF(2) products (binmat.cpp:516-616) -----------------------------------

def _dense(packed, cols: int) -> torch.Tensor:
    return unpack(packed, cols).to(torch.float32)


def mul(a, a_cols: int, at: bool, b, b_cols: int, bt: bool) -> torch.Tensor:
    """GF(2) product C = op(A) * op(B), packed; all four transpose
    combinations (the reference leaves mul_AtBt a stub, binmat.cpp:596).
    a: [ra, nwords(a_cols)], b: [rb, nwords(b_cols)]."""
    ad, bd = _dense(a, a_cols), _dense(b, b_cols)
    if at:
        ad = ad.transpose(-1, -2)
    if bt:
        bd = bd.transpose(-1, -2)
    assert ad.shape[-1] == bd.shape[-2], (
        f"GF(2) matmul dim mismatch {tuple(ad.shape)} x {tuple(bd.shape)}")
    return pack(torch.remainder(ad @ bd, 2.0) != 0)


def and_counts(a, b, cols: int) -> torch.Tensor:
    """int32 [n, m] inner products counts[i, j] = |A_i & B_j| over the first
    `cols` bits (the reference's mul_ABt shape, binmat.cpp:575)."""
    return (_dense(a, cols) @ _dense(b, cols).T).to(torch.int32)


def dist_matrix(a, b, cols: int) -> torch.Tensor:
    """int32 [n, m] all-pairs distances, JAX's |A_i| + |B_j| - 2 <A_i, B_j>
    with the inner product over the first `cols` bits: |A_i ^ B_j| where
    the padding is clean.  Kernel K5 on both inputs masked to `cols` gives
    that; bits past `cols`, which JAX's weights count, are added per row.
    Rows without padding go to K5 as they are."""
    from . import packed_dist
    if a.shape[-1] * LANE == cols:
        return packed_dist.packed_dist_matrix(to_i32(a), to_i32(b))
    m = trail_mask(cols, a.device)
    d = packed_dist.packed_dist_matrix(to_i32(a & m), to_i32(b & m))
    pad_a = popcount(from_i32(a) & ~m).sum(dim=-1, dtype=torch.int32)
    pad_b = popcount(from_i32(b) & ~m).sum(dim=-1, dtype=torch.int32)
    return d + pad_a[:, None] + pad_b[None, :]


# --- structural ops --------------------------------------------------------

def transpose(packed, rows: int, cols: int) -> torch.Tensor:
    """Packed transpose, any shape (the reference's get_transposed breaks
    on non-square matrices, binmat.cpp:199-214)."""
    return pack(unpack(packed, cols).transpose(-1, -2))


def submatrix(packed, i0: int, i1: int, j0: int, j1: int, cols: int):
    """Rows [i0, i1) x columns [j0, j1), repacked (binmat.cpp:259-298)."""
    return pack(unpack(packed, cols)[..., i0:i1, j0:j1])


def set_submatrix(packed, sub, i0: int, j0: int, cols: int, sub_cols: int):
    """Write a packed submatrix back at (i0, j0) (binmat.cpp:373-414)."""
    d = unpack(packed, cols).clone()
    s = unpack(sub, sub_cols)
    d[..., i0:i0 + s.shape[-2], j0:j0 + s.shape[-1]] = s
    return pack(d)


def unpatchify(tiles, rows: int, cols: int, W: int) -> torch.Tensor:
    """Inverse of ``patchify``, cropped back to (rows, cols)."""
    ny, nx = -(-rows // W), -(-cols // W)
    lead = tiles.shape[:-3]
    t = tiles.reshape(lead + (ny, nx, W, W)).transpose(-3, -2)
    return t.reshape(lead + (ny * W, nx * W))[..., :rows, :cols]


def vectorize_patches(tiles) -> torch.Tensor:
    """[..., N, W, W] tiles -> packed rows [..., N, nwords(W*W)]
    (binmat.cpp:300-341, without its read past the end)."""
    N, W = tiles.shape[-3], tiles.shape[-1]
    return pack(tiles.reshape(tiles.shape[:-3] + (N, W * W)))


def unvectorize_patches(packed_rows, W: int) -> torch.Tensor:
    """Packed [..., N, nwords(W*W)] -> bool tiles [..., N, W, W]."""
    bits = unpack(packed_rows, W * W)
    return bits.reshape(bits.shape[:-1] + (W, W))


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
