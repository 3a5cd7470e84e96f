"""Causal GF(2) prediction (MED) on packed words.

Counterpart of ``med_forward`` in ``binary_image_compression_tpu/ops/
predict.py`` (:56, with ``_shift_right_1bit`` and ``_shift_down_1row``):
the residual r(i,j) = P(i,j) ^ P(i-1,j) ^ P(i,j-1) ^ P(i-1,j-1), zeros
outside the image, r(0,0) = P(0,0) (DEVIATIONS.md 1), is three shifted XORs
of the packed plane.  Words are int32 bit patterns (MSB-first, bit j of a
row at bit 31 - j % 32 of word j // 32): torch on the CPU has no shifts on
uint32, so a logical right shift is an arithmetic one masked to 31 bits.
JAX computes this in XLA, outside Pallas, so torch ops are the port.
"""

from __future__ import annotations

import torch

from .bitpack import LANE, nwords


def trail_mask(cols: int, device=None) -> torch.Tensor:
    """int32 [nwords(cols)]: the bits of each word that lie inside a row."""
    m = [-1] * nwords(cols)
    if cols % LANE:
        v = (0xFFFFFFFF << (LANE - cols % LANE)) & 0xFFFFFFFF
        m[-1] = v - (1 << 32) if v >= 1 << 31 else v
    return torch.tensor(m, dtype=torch.int32, device=device)


def _shift_right_1bit(x: torch.Tensor) -> torch.Tensor:
    """Shift every packed row right by one bit (column j -> j + 1): a
    logical >> 1 in each word, with the LSB of word w - 1 carried into the
    MSB of word w."""
    shifted = (x >> 1) & 0x7FFFFFFF
    carry = (x & 1) << (LANE - 1)
    carry = torch.nn.functional.pad(carry[..., :-1], (1, 0))
    return shifted | carry


def _shift_down_1row(x: torch.Tensor) -> torch.Tensor:
    """Shift rows down by one (row i -> i + 1), zero-filling the first row."""
    return torch.nn.functional.pad(x[..., :-1, :], (0, 0, 1, 0))


def med_forward(packed: torch.Tensor, cols: int) -> torch.Tensor:
    """MED residual of packed int32 planes [..., rows, nwords(cols)]."""
    up = _shift_down_1row(packed)
    left = _shift_right_1bit(packed)
    upleft = _shift_right_1bit(up)
    r = packed ^ up ^ left ^ upleft
    return r & trail_mask(cols, packed.device)
