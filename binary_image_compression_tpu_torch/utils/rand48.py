"""GSL-compatible rand48 RNG for reference-parity dictionary learning.

The reference seeds a singleton GSL ``gsl_rng_rand48`` with the global
``random_seed = 34503498`` (bsvd.cpp:8-15, 23; settable via bsvd_test -r).
For bit-identical BSVD initializations we re-implement that generator: the
standard 48-bit LCG x <- (a*x + 11) mod 2^48 with a = 0x5DEECE66D, seeded as
GSL does (x0 = 0x330E, x1 = seed & 0xFFFF, x2 = seed >> 16), `get` returning
the top 32 bits, and GSL's uniform_int scaling-with-rejection.

This is host-side (Python int) — BSVD init runs once per model; the
device path draws from a torch.Generator instead (models/bsvd.py).  A copy
of ``binary_image_compression_tpu/utils/rand48.py``.
"""

from __future__ import annotations

_A = 0x5DEECE66D
_C = 0xB
_M48 = (1 << 48) - 1


class Rand48:
    """Drop-in for the reference's gsl_rng_rand48 usage."""

    def __init__(self, seed: int = 34503498):
        self.set_seed(seed)

    def set_seed(self, seed: int) -> None:
        seed = int(seed) & 0xFFFFFFFF
        if seed == 0:
            # GSL: seed 0 selects the generator's default state
            self._x = (0x1234 << 32) | (0xABCD << 16) | 0x330E
        else:
            self._x = (((seed >> 16) & 0xFFFF) << 32) \
                | ((seed & 0xFFFF) << 16) | 0x330E

    def _advance(self) -> None:
        self._x = (_A * self._x + _C) & _M48

    def get(self) -> int:
        """32-bit output: the high 32 of the 48-bit state (GSL rand48_get)."""
        self._advance()
        return (self._x >> 16) & 0xFFFFFFFF

    def uniform(self) -> float:
        """GSL rand48_get_double: full 48-bit mantissa in [0, 1)."""
        self._advance()
        return self._x / float(1 << 48)

    def uniform_int(self, n: int) -> int:
        """GSL gsl_rng_uniform_int: scale = range/n, rejection sample."""
        scale = 0xFFFFFFFF // n  # GSL: range/n with range = max - min
        while True:
            k = self.get() // scale
            if k < n:
                return k

    def bernoulli(self, p: float) -> int:
        """GSL gsl_ran_bernoulli(rng, p)."""
        return 1 if self.uniform() < p else 0
