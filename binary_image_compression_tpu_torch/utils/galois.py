"""GF(2^m) field and polynomial arithmetic (vectorized numpy).

The reference ships an orphan C library (maybe_usefil/galois.{h,c}:
log/antilog tables for q <= 256 plus polynomial ring ops) that its Makefile
never builds — kept there as groundwork for algebraic coding.  This is the
working equivalent: table-based field arithmetic over numpy arrays, and
polynomial add/mul/divmod/eval over GF(2^m) — enough to build RS-style
erasure protection for archive bitstreams.  A copy of
``binary_image_compression_tpu/utils/galois.py``.
"""

from __future__ import annotations

import numpy as np

# default primitive polynomials per m (x^m + ... + 1), values = bitmasks
PRIMITIVE_POLY = {
    2: 0b111, 3: 0b1011, 4: 0b10011, 5: 0b100101, 6: 0b1000011,
    7: 0b10001001, 8: 0b100011101, 9: 0b1000010001, 10: 0b10000001001,
    11: 0b100000000101, 12: 0b1000001010011,
}


class GF:
    """GF(2^m) with log/antilog tables (the reference's design, vectorized)."""

    def __init__(self, m: int, prim: int | None = None):
        if not 2 <= m <= 12:
            raise ValueError("m in [2, 12]")
        self.m = m
        self.q = 1 << m
        prim = prim or PRIMITIVE_POLY[m]
        exp = np.zeros(2 * self.q, dtype=np.int32)
        log = np.zeros(self.q, dtype=np.int32)
        x = 1
        for i in range(self.q - 1):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & self.q:
                x ^= prim
        exp[self.q - 1: 2 * (self.q - 1)] = exp[: self.q - 1]
        self.exp = exp
        self.log = log

    def add(self, a, b):
        return np.bitwise_xor(a, b)

    sub = add  # characteristic 2

    def mul(self, a, b):
        a = np.asarray(a, dtype=np.int32)
        b = np.asarray(b, dtype=np.int32)
        out = self.exp[self.log[a] + self.log[b]]
        return np.where((a == 0) | (b == 0), 0, out)

    def inv(self, a):
        a = np.asarray(a, dtype=np.int32)
        if np.any(a == 0):
            raise ZeroDivisionError("inverse of 0 in GF(2^m)")
        return self.exp[(self.q - 1) - self.log[a]]

    def div(self, a, b):
        return self.mul(a, self.inv(np.asarray(b, dtype=np.int32)))

    def pow(self, a, n: int):
        a = np.asarray(a, dtype=np.int32)
        out = self.exp[(self.log[a] * (n % (self.q - 1))) % (self.q - 1)]
        return np.where(a == 0, 0 if n else 1, out)

    # ---------------- polynomials: coefficient arrays, lowest degree first

    def poly_trim(self, p):
        p = np.asarray(p, dtype=np.int32)
        nz = np.nonzero(p)[0]
        return p[: nz[-1] + 1] if nz.size else p[:1] * 0

    def poly_add(self, p, q):
        n = max(len(p), len(q))
        out = np.zeros(n, dtype=np.int32)
        out[: len(p)] ^= np.asarray(p, dtype=np.int32)
        out[: len(q)] ^= np.asarray(q, dtype=np.int32)
        return self.poly_trim(out)

    def poly_mul(self, p, q):
        p = np.asarray(p, dtype=np.int32)
        q = np.asarray(q, dtype=np.int32)
        out = np.zeros(len(p) + len(q) - 1, dtype=np.int32)
        for i, c in enumerate(p):
            if c:
                out[i: i + len(q)] ^= self.mul(c, q)
        return self.poly_trim(out)

    def poly_divmod(self, num, den):
        num = self.poly_trim(num).copy()
        den = self.poly_trim(den)
        if len(den) == 1 and den[0] == 0:
            raise ZeroDivisionError("poly division by zero")
        if len(num) < len(den):
            return np.zeros(1, dtype=np.int32), num
        quot = np.zeros(len(num) - len(den) + 1, dtype=np.int32)
        inv_lead = int(self.inv(int(den[-1])))
        for i in range(len(quot) - 1, -1, -1):
            c = self.mul(int(num[i + len(den) - 1]), inv_lead)
            quot[i] = c
            if c:
                num[i: i + len(den)] ^= self.mul(int(c), den)
        return self.poly_trim(quot), self.poly_trim(num)

    def poly_eval(self, p, x):
        """Horner evaluation, vectorized over x."""
        x = np.asarray(x, dtype=np.int32)
        acc = np.zeros_like(x)
        for c in np.asarray(p, dtype=np.int32)[::-1]:
            acc = self.mul(acc, x) ^ c
        return acc
