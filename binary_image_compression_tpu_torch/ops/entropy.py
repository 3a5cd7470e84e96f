"""Codelengths and the adaptive Golomb-Rice and exp-Golomb counters.

Counterpart of ``lnchoose``, ``enum_codelength``, ``universal_codelength``,
``enum_codelength_jnp`` and ``universal_codelength_jnp`` (as
``enum_codelength_t`` and ``universal_codelength_t``), ``GolombCoder``,
``golomb_scan``, ``EGCoder`` and the exp-Golomb table ``EGLUT`` in
``binary_image_compression_tpu/ops/entropy.py`` (reference coding.cpp:19-32,
Golomb.h:12-29, GolombCoder.cpp:13-34, eg.cpp:2-37).  The reference's coders
only count bits; so do these.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .bitpack import to_i32

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


def enum_codelength_t(n, r) -> torch.Tensor:
    """Elementwise ``enum_codelength`` in float32 by ``torch.lgamma``, the
    twin of JAX's ``enum_codelength_jnp``; 0 where r == 0."""
    r = torch.as_tensor(r).to(torch.float32)
    n = torch.as_tensor(n, dtype=torch.float32, device=r.device)
    ln = torch.lgamma(n + 1) - torch.lgamma(r + 1) - torch.lgamma(n - r + 1)
    return torch.where(r > 0, ln * COSMOS_LOG2E,
                       torch.zeros((), dtype=torch.float32, device=r.device))


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


def golomb_scan(samples) -> tuple[torch.Tensor, torch.Tensor]:
    """``GolombCoder`` over a 1-D stream of uint32 samples, as JAX's in-graph
    scan computes it: (int32 bit length of each sample, int32 total).  The
    state is uint32: n << k wraps at 32 bits, and where no k < 32 gives
    (n << k) >= accumulated error, k is 31 (``GolombCoder`` takes 32
    there; both as in JAX)."""
    u = torch.as_tensor(samples).to(torch.int64) & _U32
    lens = []
    acc, n, k = 0, 0, 1
    for x in u.tolist():
        lens.append((k + (x >> k) + 1) & _U32)
        n = (n + 1) & _U32
        acc = (acc + x) & _U32
        k = 0
        while k < 32 and ((n << k) & _U32) < acc:
            k += 1
        k = min(k, 31)
    out = to_i32(torch.tensor(lens, dtype=torch.int64, device=u.device))
    return out, out.sum(dtype=torch.int32)


@dataclass
class EGCoder:
    """The reference's run-length codelength counter (eg.cpp:20-37), not
    codec 10's coder.

    ``adaptive=False`` (default) is the reference as shipped: codeRun never
    grows the block (incBlockSize is commented out at eg.cpp:25), so with
    blockSize = 1 the full-block part is unary.  ``adaptive=True`` is the
    intended MELCODE adaptation (grow on a full block, shrink on a
    remainder), with the LUT index clamped to 31 where the reference reads
    EGLUT[32] (eg.cpp:4-10; DEVIATIONS.md)."""
    adaptive: bool = False
    g: int = 1          # eg.h ctor
    block_size: int = 1
    lut_index: int = 0
    bitcount: int = 0

    def _inc(self):
        if self.lut_index < 31:
            self.lut_index += 1
        self.g = EGLUT[self.lut_index]
        self.block_size = 1 << self.g

    def _dec(self):
        if self.lut_index > 0:
            self.lut_index -= 1
        self.g = EGLUT[self.lut_index]
        self.block_size = 1 << self.g

    def code_run(self, length: int, eol: bool) -> int:
        n0 = self.bitcount
        while length >= self.block_size:
            length -= self.block_size
            self.bitcount += 1
            if self.adaptive:
                self._inc()
        if eol:
            self.bitcount += 1
        else:
            self.bitcount += self.g + 1
            self._dec()
        return self.bitcount - n0
