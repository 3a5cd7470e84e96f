"""Codelengths and the adaptive Golomb-Rice context.

Counterpart of ``lnchoose``, ``enum_codelength``, ``universal_codelength``,
``universal_codelength_jnp`` (as ``universal_codelength_t``),
``GolombCoder`` and the adaptive exp-Golomb table ``EGLUT`` in
``binary_image_compression_tpu/ops/entropy.py`` (reference coding.cpp:19-32,
Golomb.h:12-29, GolombCoder.cpp:13-34, eg.cpp:2).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

COSMOS_LOG2E = 1.442695040888963387004650940070860087872  # coding.h:10

_U32 = 0xFFFFFFFF

# Adaptive exponential-Golomb run coder (codec 10): the remainder width g of
# each of the 32 LUT states (eg.cpp:2), and the block size 2^g it consumes
EGLUT = (0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
         4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15)
EG_BLOCKS = tuple(1 << g for g in EGLUT)


def lnchoose(n: int, r: int) -> float:
    """ln C(n, r) (gsl_sf_lnchoose)."""
    if r > n:
        raise ValueError("r > n")
    if r == n or r == 0:
        return 0.0
    return math.lgamma(n + 1) - math.lgamma(r + 1) - math.lgamma(n - r + 1)


def enum_codelength(n: int, r: int) -> float:
    """log2 C(n, r) in bits; 0 for r == 0 (reference enumL, coding.cpp:19)."""
    return lnchoose(n, r) * COSMOS_LOG2E if r > 0 else 0.0


def universal_codelength(n: int, r: int) -> float:
    """n*H(r/n) + 0.5*log2(n) (reference coding.cpp:24-32)."""
    if 0 < r < n:
        p1 = r / n
        return n * (-p1 * math.log2(p1) - (1.0 - p1) * math.log2(1.0 - p1)) \
            + 0.5 * math.log2(n)
    return 0.5 * math.log2(n)


def universal_codelength_t(n, r) -> torch.Tensor:
    """Elementwise ``universal_codelength`` in float32, the twin of JAX's
    ``universal_codelength_jnp``: the MDL drivers compare these float32
    values, so the port computes them in the same type and order."""
    r = torch.as_tensor(r).to(torch.float32)
    n = torch.as_tensor(n, dtype=torch.float32, device=r.device)
    p = r / n
    one = torch.ones((), dtype=torch.float32, device=r.device)
    h = -p * torch.log2(torch.where(p > 0, p, one)) \
        - (1 - p) * torch.log2(torch.where(p < 1, 1 - p, one))
    mid = n * h + 0.5 * torch.log2(n)
    return torch.where((r > 0) & (r < n), mid, 0.5 * torch.log2(n))


@dataclass
class GolombCoder:
    """Context-adaptive Rice codelength counter, bit-exact vs the reference.

    code_sample(u) adds k + (u >> k) + 1 bits, then re-derives
    k = min{k : (samples << k) >= accumulated_error} from scratch
    (GolombCoder.cpp:29-33).  State arithmetic is 32-bit unsigned, as in C.
    """
    accumulated_error: int = 0
    samples: int = 0
    k: int = 1
    bitcount: int = 0

    def code_sample(self, u: int) -> int:
        nbits = self.k + (int(u) >> self.k) + 1
        self.bitcount += nbits
        self.samples = (self.samples + 1) & _U32
        self.accumulated_error = (self.accumulated_error + int(u)) & _U32
        k = 0
        # C `unsigned` shift: on x86 the count is masked mod 32; cap at 31
        while k < 32 and ((self.samples << k) & _U32) < self.accumulated_error:
            k += 1
        self.k = k
        return nbits
