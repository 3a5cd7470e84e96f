"""Causal GF(2) prediction (MED) on packed words.

Counterpart of ``med_forward`` (:56, with ``_shift_right_1bit`` and
``_shift_down_1row``), ``_prefix_xor_bits`` (:70), ``med_inverse`` (:88)
and the dense-bool oracles ``np_med_forward`` / ``np_med_inverse`` (:99,
:111) and ``predictor_matrices`` (:121) in
``binary_image_compression_tpu/ops/predict.py``: the residual
r(i,j) = P(i,j) ^ P(i-1,j) ^ P(i,j-1) ^ P(i-1,j-1), zeros outside the
image, r(0,0) = P(0,0) (DEVIATIONS.md 1), is three shifted XORs of the
packed plane, and its inverse a prefix XOR along each row and then down
each column.  Words are int32 bit patterns (MSB-first, bit j of a row at
bit 31 - j % 32 of word j // 32): torch on the CPU has no shifts on uint32,
so a logical right shift is an arithmetic one masked to the bits it keeps.
JAX computes this in XLA, outside Pallas, so torch ops are the port.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bitpack
from .bitpack import LANE, trail_mask


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


def _prefix_xor_bits(x: torch.Tensor) -> torch.Tensor:
    """Within-row prefix XOR across the bits of packed int32 words: a
    Kogge-Stone scan inside each word (bit k of the MSB-first row takes bits
    0..k), then each word XORed with the parity of the words before it."""
    for s in (1, 2, 4, 8, 16):
        x = x ^ ((x >> s) & ((1 << (LANE - s)) - 1))
    parity = x & 1
    carry = (torch.cumsum(parity, dim=-1) - parity) & 1
    return x ^ -carry.to(x.dtype)            # -1: all 32 bits flipped


def _prefix_xor_rows(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR down the rows (axis -2), a log-step scan (JAX's
    ``associative_scan``; torch has no cumulative XOR)."""
    shift = 1
    while shift < x.shape[-2]:
        x = torch.cat([x[..., :shift, :],
                       x[..., shift:, :] ^ x[..., :-shift, :]], dim=-2)
        shift *= 2
    return x


def med_inverse(residual: torch.Tensor, cols: int) -> torch.Tensor:
    """Exact inverse of ``med_forward``: the prefix XOR along each row, then
    down each column."""
    x = _prefix_xor_rows(_prefix_xor_bits(residual))
    return x & trail_mask(cols, x.device)


def np_med_forward(p: np.ndarray) -> np.ndarray:
    """Dense-bool oracle of the reference MED loop (pred.cpp:3-15)."""
    p = np.asarray(p, dtype=bool)
    r = np.zeros_like(p)
    r[..., 0, 1:] = p[..., 0, 1:] ^ p[..., 0, :-1]
    r[..., 1:, 0] = p[..., 1:, 0] ^ p[..., :-1, 0]
    r[..., 1:, 1:] = (p[..., 1:, 1:] ^ p[..., :-1, 1:]
                      ^ p[..., 1:, :-1] ^ p[..., :-1, :-1])
    r[..., 0, 0] = p[..., 0, 0]
    return r


def np_med_inverse(r: np.ndarray) -> np.ndarray:
    """Dense-bool inverse: prefix XOR along the rows, then the columns."""
    r = np.asarray(r, dtype=bool)
    x = np.bitwise_xor.accumulate(r, axis=-1)
    return np.bitwise_xor.accumulate(x, axis=-2)


def predictor_matrices(M: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's bidiagonal difference matrix D and its inverse iD
    (compress6_test.cpp:64-76), numpy uint32 words with cols = M: D has ones
    on the diagonal and at D[i - 1, i], iD is the upper triangle of ones, so
    a vectorized patch row V codes predictively as V D over GF(2)."""
    D = np.zeros((M, M), dtype=bool)
    iD = np.zeros((M, M), dtype=bool)
    idx = np.arange(M)
    D[idx, idx] = True
    D[idx[:-1], idx[1:]] = True
    iD[np.triu_indices(M)] = True
    return bitpack.np_pack(D), bitpack.np_pack(iD)
