"""MSB-first bit IO, Golomb-Rice and exact enumerative coding.

Counterpart of ``binary_image_compression_tpu/ops/bitstream.py``
(``BitWriter``, ``BitReader``, ``golomb_encode``, ``golomb_decode``,
``_binom_table``, ``enum_nbits``, ``enum_rank``, ``enum_unrank``,
``enum_encode``, ``enum_decode``, ``pack_varlen``, ``words_to_bytes``).
The bit IO is pure Python: the plain version of the native record packer
(``models/compress.pack_records_plain``) and the codec-11 stream writer and
reader (``models/codec``).  ``pack_varlen`` packs variable-length codes in
torch ops: codec 13's table section on the device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

U32 = 0xFFFFFFFF


class BitWriter:
    """MSB-first bit accumulator producing bytes."""

    def __init__(self):
        self._acc = 0
        self._nacc = 0
        self._out = bytearray()

    def write_bits(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        self._acc = (self._acc << nbits) | value
        self._nacc += nbits
        while self._nacc >= 8:
            self._nacc -= 8
            self._out.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def write_unary_zeros(self, n: int) -> None:
        while n >= 32:
            self.write_bits(0, 32)
            n -= 32
        self.write_bits(0, n)

    def getvalue(self) -> bytes:
        if self._nacc:
            pad = 8 - self._nacc
            return bytes(self._out) + bytes([(self._acc << pad) & 0xFF])
        return bytes(self._out)


class BitReader:
    """MSB-first bit reader over bytes."""

    def __init__(self, data: bytes, bit_offset: int = 0):
        self._data = data
        self._pos = bit_offset

    def read_bits(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        p = self._pos
        first, last = p >> 3, (p + nbits - 1) >> 3
        if last >= len(self._data):
            raise IndexError("read past the end of the stream")
        chunk = int.from_bytes(self._data[first:last + 1], "big")
        span = (last - first + 1) * 8
        self._pos = p + nbits
        return (chunk >> (span - (p & 7) - nbits)) & ((1 << nbits) - 1)

    def read_unary_zeros(self) -> int:
        """Count zeros up to (and consuming) the terminating 1 bit."""
        n = 0
        while self.read_bits(1) == 0:
            n += 1
        return n


def golomb_encode(w: BitWriter, u: int, k: int) -> None:
    """Low k bits of u, then (u >> k) zeros, then a 1 (GolombCoder.cpp:21-25)."""
    w.write_bits(u, k)
    w.write_unary_zeros(u >> k)
    w.write_bits(1, 1)


def golomb_decode(r: BitReader, k: int) -> int:
    low = r.read_bits(k)
    high = r.read_unary_zeros()
    return (high << k) | low


@lru_cache(maxsize=None)
def _binom_table(n: int):
    """Pascal triangle of Python ints up to C(n, k)."""
    C = [[0] * (n + 1) for _ in range(n + 1)]
    for i in range(n + 1):
        C[i][0] = 1
        for j in range(1, i + 1):
            C[i][j] = C[i - 1][j - 1] + C[i - 1][j]
    return C


def enum_nbits(n: int, w: int) -> int:
    """Bits of the rank of a weight-w pattern over n positions: ceil(log2 C)."""
    c = _binom_table(n)[n][w]
    return max(0, (c - 1).bit_length())


def enum_rank(positions: np.ndarray, n: int) -> int:
    """Lexicographic rank of the sorted 1-positions among C(n, w)."""
    C = _binom_table(n)
    rank = 0
    prev = -1
    rem = len(positions)
    for p in positions:
        for q in range(prev + 1, int(p)):
            rank += C[n - 1 - q][rem - 1]
        prev = int(p)
        rem -= 1
    return rank


def enum_encode(w: BitWriter, bits: np.ndarray) -> None:
    """Write a 0/1 vector of known length and weight as its rank."""
    bits = np.asarray(bits).astype(bool).ravel()
    n = bits.size
    pos = np.nonzero(bits)[0]
    nb = enum_nbits(n, len(pos))
    rank = enum_rank(pos, n)
    # the (possibly > 64 bit) rank MSB-first in 32-bit chunks
    for shift in range(((nb + 31) // 32) * 32 - 32, -1, -32):
        chunk_bits = min(32, nb - shift)
        if chunk_bits > 0:
            w.write_bits((rank >> shift) & 0xFFFFFFFF, chunk_bits)


def enum_unrank(rank: int, n: int, w: int) -> np.ndarray:
    """Inverse of ``enum_rank``: the sorted 1-positions of rank `rank`."""
    C = _binom_table(n)
    positions = np.empty(w, dtype=np.int64)
    q = 0
    rem = w
    for i in range(w):
        while True:
            c = C[n - 1 - q][rem - 1]
            if rank < c:
                break
            rank -= c
            q += 1
        positions[i] = q
        q += 1
        rem -= 1
    return positions


def enum_decode(r: BitReader, n: int, weight: int) -> np.ndarray:
    """Read a weight-`weight` 0/1 vector of length n written by
    ``enum_encode``."""
    nb = enum_nbits(n, weight)
    rank = 0
    remaining = nb
    while remaining > 0:
        take = min(32, remaining)
        rank = (rank << take) | r.read_bits(take)
        remaining -= take
    bits = np.zeros(n, dtype=bool)
    if weight:
        bits[enum_unrank(rank, n, weight)] = True
    return bits


def pack_varlen(values: torch.Tensor, lengths: torch.Tensor,
                total_words: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Variable-length codes of up to 32 bits, back to back, MSB-first, in
    32-bit words (JAX ``bitstream.pack_varlen`` :198), over the last dim.

    values[..., i] holds lengths[..., i] significant bits (right-aligned),
    both int64.  Returns (words int64 [..., total_words] of uint32 values,
    total_bits int64 [...]).  Offsets come from an exclusive cumsum; a code
    straddles at most two words, so the packing is two ``scatter_add_``
    (codes never overlap, so add is OR).  As in JAX, a head past the last
    word is dropped and a tail past it lands in the last word."""
    values = values.to(torch.int64)
    lengths = lengths.to(torch.int64)
    starts = torch.cumsum(lengths, dim=-1) - lengths     # exclusive prefix
    total_bits = lengths.sum(dim=-1)
    word_idx = starts // 32
    bit_in = starts % 32
    mask = torch.where(lengths >= 32, U32,
                       (1 << torch.clamp(lengths, max=31)) - 1)
    v = values & mask
    end = bit_in + lengths                  # <= 63: bit_in <= 31, len <= 32
    hi = torch.where(end <= 32, v << torch.clamp(32 - end, 0, 31),
                     v >> torch.clamp(end - 32, 0, 31)) & U32
    lo = torch.where(end <= 32, 0, v << torch.clamp(64 - end, 0, 31)) & U32
    words = torch.zeros(values.shape[:-1] + (total_words + 1,),
                        dtype=torch.int64, device=values.device)
    # heads past the last word go to the spare slot, which is then dropped
    words.scatter_add_(-1, torch.clamp(word_idx, max=total_words), hi)
    words.scatter_add_(-1, torch.clamp(word_idx + 1, max=total_words - 1),
                       lo)
    return words[..., :total_words], total_bits


def words_to_bytes(words: np.ndarray, total_bits: int) -> bytes:
    """Big-endian bytes of a uint32 word stream, trimmed to
    ceil(total_bits / 8) (JAX ``bitstream.words_to_bytes`` :234)."""
    words = np.asarray(words, dtype=np.uint32)
    return words.astype(">u4").tobytes()[: (int(total_bits) + 7) // 8]
