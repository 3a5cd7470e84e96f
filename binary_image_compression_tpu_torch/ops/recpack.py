"""Kernel K9: codec 8's decided tile records packed into the BIC1 payload on
the device.

Replaces no TPU kernel: the JAX package fetches the record block and packs
it on the host (native ``bic_pack_tiles``), as ``compress._pack_decided``
still does off the CUDA route.  The input is the int32 [B, T, 2 + nw]
record block of ``compress._record_block`` (column 0: mode 2b | inv 1b |
k_used 5b | idx_len 6b | weight 17b; column 1: the rank; then the chosen
residual's nw = ceil(M / 32) words, MSB-first as ``bitpack.np_unpack``
reads them).  Each tile's record, in raster order:

  * modes 0 and 1: '1', m & 1, inv, then the rank in idx_len bits; modes 2
    and 3: '0', m & 1;
  * the Golomb code of the weight w with k = k_used: the low k bits, w >> k
    zeros, a '1';
  * the enumerative rank of the residual in ``enb_table(M)[w]`` bits: the
    sum, over its zero positions q while rem > 0, of C(M - 1 - q, rem - 1),
    rem being w less the ones before q (``bitstream.enum_rank``; native
    ``enum_rank_tab``).

``pack_records`` launches ``csrc/pack_records.cu`` for a CUDA tensor and
runs ``pack_records_plain`` for a CPU tensor.  Both return (words, nbits):
words int32 [capacity_words(B, T, M)], every page's payload back to back,
each page from a word, the buffer's bytes in memory order being the stream
(each word byte-swapped); the rest zero.  nbits int64 [B]: each payload's
length in bits, -1 for a page with a weight outside [0, M], which then
takes no words.  ``page_layout`` turns the bit counts into each page's
bytes of the buffer.  M is at most ``MAX_M`` (W <= 16): C(255, 127) < 2^252
fits the table's eight 32-bit limbs.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from . import _cuda, bitpack
from .bitstream import _binom_table, enum_nbits

MAX_M = 256             # the binomial table's reach (bic_pack_tiles' too)
LIMBS = 8               # 32-bit limbs of a rank below C(256, 128)
U32 = 0xFFFFFFFF


@lru_cache(maxsize=None)
def enb_table(M: int, device=torch.device("cpu")) -> torch.Tensor:
    """int32 [M + 1]: the enumerative rank's bits for each weight
    (``bitstream.enum_nbits``), held on `device` (once per device and M)."""
    return torch.tensor([enum_nbits(M, w) for w in range(M + 1)],
                        dtype=torch.int32, device=device)


@lru_cache(maxsize=None)
def binom_table(M: int, device=torch.device("cpu")) -> torch.Tensor:
    """int32 [M (M + 1) / 2, LIMBS]: C(a, r) for r <= a < M at a (a + 1) / 2
    + r (``bitstream._binom_table``), in 32-bit limbs, least first (uint32
    bit patterns), on `device` (once per device and M)."""
    if not 1 <= M <= MAX_M:
        raise ValueError(f"K9's table takes M in [1, {MAX_M}], not {M}")
    C = _binom_table(M - 1)
    raw = b"".join(C[a][r].to_bytes(4 * LIMBS, "little")
                   for a in range(M) for r in range(a + 1))
    limbs = np.frombuffer(raw, dtype="<u4").reshape(-1, LIMBS)
    return torch.from_numpy(limbs.view(np.int32).copy()).to(device)


def record_bits_max(M: int) -> int:
    """The longest record at M: '1' m inv and a 63-bit rank, k + (w >> k) +
    1 <= M + 1 for w <= M, and the widest enumerative rank."""
    return 3 + 63 + M + 1 + int(enb_table(M).max())


def capacity_words(B: int, T: int, M: int) -> int:
    """The payload buffer of B pages of T tiles, in 32-bit words."""
    return B * -(-T * record_bits_max(M) // 32)


def page_layout(nbits) -> tuple[list[int], list[int], int]:
    """Host side of the layout: (first byte of each page, its payload
    bytes, words the pages use) from the bit counts (a page of -1 takes
    none)."""
    starts, sizes, word = [], [], 0
    for n in (int(x) for x in nbits):
        starts.append(4 * word)
        sizes.append(-(-n // 8) if n > 0 else 0)
        word += -(-n // 32) if n > 0 else 0
    return starts, sizes, word


def _check(block: torch.Tensor, M: int) -> None:
    if not 1 <= M <= MAX_M:
        raise ValueError(f"K9 packs records of M <= {MAX_M} bits (W <= 16), "
                         f"not M = {M}")
    nw = bitpack.nwords(M)
    if (block.dtype != torch.int32 or block.dim() != 3
            or block.shape[2] != 2 + nw or not block.is_contiguous()):
        raise ValueError(f"K9: block must be contiguous int32 [B, T, "
                         f"{2 + nw}], not {block.dtype} {tuple(block.shape)}")


def _fields(block: torch.Tensor):
    h = block[..., 0].to(torch.int64)
    return h & 3, (h >> 2) & 1, (h >> 3) & 31, (h >> 8) & 63, h >> 14


def enum_ranks_plain(residual: torch.Tensor, weight: torch.Tensor, M: int,
                     chunk: int = 2048) -> torch.Tensor:
    """int64 [N, LIMBS]: each residual's enumerative rank mod 2^(32 LIMBS),
    in 32-bit limbs, least first.  residual: int32 [N, nwords(M)]; weight:
    [N] in [0, M], counted down from at each one as ``enum_rank_tab``
    does."""
    dev = residual.device
    table = binom_table(M, dev).to(torch.int64) & U32
    a = M - 1 - torch.arange(M, device=dev)
    out = []
    for s in range(0, residual.shape[0], chunk):
        bits = bitpack.unpack(residual[s:s + chunk], M).to(torch.int64)
        rem = weight[s:s + chunk, None] - (bits.cumsum(1) - bits)
        take = (bits == 0) & (rem > 0) & (rem - 1 <= a)
        idx = torch.where(take, a * (a + 1) // 2 + rem - 1, 0)
        acc = (table[idx] * take[..., None]).sum(1)      # < 2^40 a limb
        limbs, carry = [], 0
        for j in range(LIMBS):
            v = acc[:, j] + carry
            limbs.append(v & U32)
            carry = v >> 32
        out.append(torch.stack(limbs, 1))
    return (torch.cat(out) if out
            else torch.zeros(0, LIMBS, dtype=torch.int64, device=dev))


def _segment(j, start, length, value):
    """Bits of `value` ([N, 1]) laid MSB-first over record positions
    [start, start + length) of j ([1, L]); 0 elsewhere."""
    inside = (j >= start) & (j < start + length)
    i = (start + length - 1 - j).clamp(0, 63)
    return inside & ((value >> i) & 1).bool()


def pack_records_plain(block: torch.Tensor, M: int, chunk: int = 2048):
    """Plain PyTorch K9 (exact integer limbs): every record's bits laid out
    one by one and scattered into the stream.  Returns what
    ``pack_records`` returns."""
    _check(block, M)
    B, T, _ = block.shape
    dev = block.device
    mode, inv, k, il, w = _fields(block)
    bad = ((w < 0) | (w > M)).any(dim=1)
    w = w.clamp(0, M)
    e = enb_table(M, dev).to(torch.int64)[w]
    match = mode < 2
    head = torch.where(match, 3, 2)
    il = torch.where(match, il, 0)
    z = w >> k
    length = torch.where(bad[:, None], 0, head + il + k + z + 1 + e)
    nbits = torch.where(bad, -1, length.sum(1))
    page_words = (length.sum(1) + 31) // 32
    first = (torch.cumsum(page_words, 0) - page_words) * 32
    off = (first[:, None] + length.cumsum(1) - length).reshape(-1)
    limbs = enum_ranks_plain(block[..., 2:].reshape(B * T, -1),
                             w.reshape(-1), M)
    flat = lambda t: t.reshape(-1, 1)
    pv = torch.where(match, 4 | (mode & 1) << 1 | inv, mode & 1)
    rank = block[..., 1].to(torch.int64)
    cols = [flat(t) for t in (head, pv, il, rank, k, w, z, e, length)]
    stream = torch.zeros(capacity_words(B, T, M) * 32, dtype=torch.uint8,
                         device=dev)
    for s in range(0, B * T, chunk):
        hd, pv_, il_, rk, k_, w_, z_, e_, ln = (c[s:s + chunk] for c in cols)
        if not int(ln.max()):
            continue
        j = torch.arange(int(ln.max()), device=dev)[None]
        bit = _segment(j, 0, hd, pv_)
        bit |= _segment(j, hd, il_, rk)
        bit |= _segment(j, hd + il_, k_, w_)
        bit |= _segment(j, hd + il_ + k_ + z_, 1, torch.ones_like(w_))
        start = hd + il_ + k_ + z_ + 1
        i = (start + e_ - 1 - j).clamp(0, 32 * LIMBS - 1)
        lb = torch.gather(limbs[s:s + chunk], 1, i >> 5) >> (i & 31)
        bit |= (j >= start) & (j < start + e_) & (lb & 1).bool()
        bit &= j < ln
        pos = (off[s:s + chunk, None] + j)[bit]
        stream[pos] = 1
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                           device=dev)
    by = (stream.view(-1, 8) * weights).sum(1, dtype=torch.uint8)
    return by.view(torch.int32), nbits


def pack_records(block: torch.Tensor, M: int):
    """K9 over a decided record block, every page in one launch: (words,
    nbits) as the module's note sets out.  CUDA tensors launch the kernel;
    CPU tensors run ``pack_records_plain``."""
    if block.is_cuda:
        return _launch(block, M)
    if block.device.type == "cpu":
        return pack_records_plain(block, M)
    raise RuntimeError(f"K9 has no kernel for device {block.device}")


def _launch(block: torch.Tensor, M: int):
    """Launch csrc/pack_records.cu's two kernels on the current stream."""
    _check(block, M)
    B, T, _ = block.shape
    dev = block.device
    words = torch.zeros(capacity_words(B, T, M), dtype=torch.int32,
                        device=dev)
    # the pages' bit counts, their first words, the blocks-done counter
    aux = torch.zeros(2 * B + 1, dtype=torch.int64, device=dev)
    off = torch.empty(B * T, dtype=torch.int64, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    lib = _cuda.get_lib()
    _cuda.check(lib.bic_pack_records(
        ptr(block), ptr(enb_table(M, dev)), ptr(binom_table(M, dev)),
        ptr(off), ptr(aux), ptr(aux[B:]), ptr(aux[2 * B:]), ptr(words), B, T,
        bitpack.nwords(M), M, _cuda.stream(dev)), "bic_pack_records")
    _cuda.launches["pack_records"] += 1
    return words, aux[:B]
