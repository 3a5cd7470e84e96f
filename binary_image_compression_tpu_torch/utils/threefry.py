"""A numpy replay of JAX's default random draws (threefry2x32).

The JAX package's BSVD initializers draw from ``jax.random`` keys
(``PRNGKey``, ``split``, ``randint``, ``bernoulli``, ``choice`` without
replacement).  The port replays those draws bit for bit on the host, so
that for the same seed both packages start from the same state and write
the same codec-11 stream.  This follows JAX 0.9 with 32-bit types and
``jax_threefry_partitionable`` on (its default there):

* a key is two uint32 words; ``PRNGKey(seed)`` is [0, seed];
* ``random_bits(key, shape)`` hashes the flat index of each element, as
  two words (high, low), under the key and XORs the two output words;
* ``split(key, n)`` is the same hash of 0..n-1, both words kept;
* ``randint`` draws two such arrays from the two halves of a split and
  combines them modulo the span (JAX's formula, wrapping in uint32);
* ``bernoulli(key, 0.5)`` is ``uniform < 0.5``, the uniform float made from
  the top 23 bits;
* ``choice(n, (k,), replace=False)`` is the first k of a permutation made
  by stable sorts on fresh random keys.

Keys are numpy uint32 [2] arrays.  Everything here is host numpy; the
callers move the draws to their device.
"""

from __future__ import annotations

import math

import numpy as np

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The threefry2x32 block cipher (20 rounds) of the counter pairs
    (x0, x1) under `key`, as JAX computes it."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in int32 range."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} is outside int32 (JAX's range "
                            "without 64-bit types)")
    return np.array([0, seed & 0xFFFFFFFF], dtype=_U32)


def _hash_iota(key, shape) -> tuple[np.ndarray, np.ndarray]:
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    b0, b1 = threefry2x32(key, hi, lo)
    return b0.reshape(shape), b1.reshape(shape)


def random_bits(key, shape) -> np.ndarray:
    """uint32 bits of the given shape (``jax.random.bits``)."""
    b0, b1 = _hash_iota(key, tuple(shape))
    return b0 ^ b1


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: uint32 [num, 2] keys."""
    b0, b1 = _hash_iota(key, (num,))
    return np.stack([b0, b1], axis=1)


def randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` of int32 values in [minval, maxval)."""
    shape = tuple(shape)
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(maxval - minval) if maxval > minval else _U32(1)
    with np.errstate(over="ignore"):
        mult = _U32(2 ** 16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform`` float32 in [0, 1)."""
    bits = random_bits(key, tuple(shape))
    f = ((bits >> _U32(9)) | _U32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def bernoulli(key, p: float, shape) -> np.ndarray:
    """``jax.random.bernoulli``: bool, uniform < p in float32."""
    return uniform(key, shape) < np.float32(p)


def permutation(key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: stable sorts of 0..n-1 on fresh
    32-bit keys, as many rounds as JAX takes for n."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2 ** 32 - 1)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def choice(key, n: int, k: int) -> np.ndarray:
    """``jax.random.choice(key, n, (k,), replace=False)``: int32 [k]."""
    if k > n:
        raise ValueError(f"cannot take {k} distinct draws from {n}")
    return permutation(key, n)[:k]
