"""Codec 13's device entropy mode: static-table interleaved rANS (mode 2).

Counterpart of ``binary_image_compression_tpu/ops/ransdevice.py``.  The
page's per-context bit counts build a quantized static probability table
(``count_contexts``, ``build_table``); each stripe's pixels are then coded
by N interleaved rANS lanes (32-bit state, 16-bit renormalisation, 12-bit
frequencies), lane l taking pixels t*N + l of the stripe, in reverse
order, so that the decoder (native ``bic_scab_rans_decode``) reads the
words forwards.

Coder maths (per symbol, freq f out of 4096, cdf base b):
  encode (reverse order):  if (x >> 20) >= f: emit x & 0xFFFF, x >>= 16
                           x = ((x // f) << 12) + x % f + b
A padding symbol with f = 4096, b = 0 is an exact no-op: it pads stripes
to a whole number of steps, and the decoder never reads it.

``rans_encode`` is kernel K7 (``csrc/rans_encode.cu``, note at its top):
one CUDA block per stripe walks the steps backwards and writes each
stripe's word stream itself.  For CPU tensors it runs ``rans_stripes_plain``:
the per-pixel (f, b) in the stripe layout, the reverse loop
``rans_encode_plain`` (JAX ``rans_encode_scan`` without its unroll) and
``bitstream.pack_varlen`` of the emitted words in stream order.

The context counts are one integer ``torch.bincount`` (JAX's MXU one-hot
histogram and its 2^24 float32 bound are a TPU workaround), and the table
lookup a plain gather.  JAX's ``count_contexts`` takes a ``mask`` that no
caller passes; it is left out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda, bitpack
from .bitstream import pack_varlen

PROB_BITS = 12                      # freqs sum to 4096
PSCALE = 1 << PROB_BITS
CODE_BITS = 6                       # logit-quantized probability codes
N_LANES_DEFAULT = 32
MAX_LANES = 255                     # the payload's n_lanes field is a u8
TABLE_WORDS = -(-PSCALE * CODE_BITS // 32)

# 64-entry logit-uniform probability table: code q -> P(bit==1) * 4096
# (JAX ransdevice.py:49-65; the native decoder holds the same table)
LOGIT64 = np.asarray([
    1, 2, 2, 3, 4, 5, 6, 8, 10, 13, 17, 22, 29, 37, 48, 61,
    78, 101, 129, 164, 209, 266, 337, 424, 531, 659, 812, 990,
    1193, 1419, 1663, 1918, 2178, 2433, 2677, 2903, 3106, 3284,
    3437, 3565, 3672, 3759, 3830, 3887, 3932, 3967, 3995, 4018,
    4035, 4048, 4059, 4067, 4074, 4079, 4083, 4086, 4088, 4090,
    4091, 4092, 4093, 4094, 4094, 4095], dtype=np.int32)


def quantize_probs(ones: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """6-bit probability codes from counts: the nearest LOGIT64 code to the
    Krichevsky-Trofimov estimate (ones + 1/2) / (total + 1), in float32
    with JAX's order of operations (int32 result)."""
    ones = ones.to(torch.float32)
    total = total.to(torch.float32)
    p = (ones + 0.5) / (total + 1.0)
    logit = torch.log(p / (1.0 - p))
    q = torch.round((torch.clamp(logit, -8.0, 8.0) + 8.0) * (63.0 / 16.0))
    return torch.clamp(q, 0, 63).to(torch.int32)


def _cost_bits(ones, zeros, p12):
    """Coded bits of (ones, zeros) under a static 12-bit probability."""
    pf = p12.to(torch.float32) / PSCALE
    return -(ones * torch.log2(pf) + zeros * torch.log2(1.0 - pf))


def build_table(ones: torch.Tensor, total: torch.Tensor):
    """(q [4096] int32, transmit [4096] bool, q_default [] int32,
    p_used [4096] int32).

    A context is transmitted iff its own quantized probability saves more
    than its 6-bit code and ~6 bits of bitmap over the page-wide default.
    The default's counts are summed as integers (JAX sums them in float32,
    the same value for pages below 2^24 pixels)."""
    q_def = quantize_probs(ones.sum(), total.sum())
    ones = ones.to(torch.float32)
    total = total.to(torch.float32)
    zeros = total - ones
    q = quantize_probs(ones, total)
    lut = torch.from_numpy(LOGIT64).to(q.device)
    p_own = lut[q]
    p_def = lut[q_def]
    save = _cost_bits(ones, zeros, p_def) - _cost_bits(ones, zeros, p_own)
    transmit = (total > 0) & (save > CODE_BITS + 6.0)
    p_used = torch.where(transmit, p_own, p_def)
    return q, transmit, q_def, p_used


def count_contexts(ctx: torch.Tensor, bits: torch.Tensor):
    """(ones [4096], total [4096]) int64 per-context bit counts: one
    ``bincount`` of ctx * 2 + bit."""
    v = torch.bincount(ctx.reshape(-1).to(torch.int64) * 2
                       + bits.reshape(-1).to(torch.int64),
                       minlength=2 * PSCALE).reshape(PSCALE, 2)
    return v[:, 1], v[:, 0] + v[:, 1]


def table_lookup(table: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    """table[ctx]: each pixel's P(bit == 1) * 4096."""
    return table[ctx.to(torch.int64)]


def rans_encode_plain(f: torch.Tensor, b: torch.Tensor):
    """The interleaved-rANS encode loop (JAX ``rans_encode_scan`` :167).

    f, b: int64 [steps, S, N] per-symbol freq and cdf base (stripe s, step
    t, lane l holds pixel t*N + l of stripe s).  Returns (states int64
    [S, N], the decoder's initial states; words int64 [steps, S, N];
    flags bool [steps, S, N]), all uint32 values; stripe s's stream is its
    flagged words in ascending (step, lane) order."""
    steps = f.shape[0]
    x = torch.full(f.shape[1:], 1 << 16, dtype=torch.int64, device=f.device)
    words = torch.zeros(f.shape, dtype=torch.int64, device=f.device)
    flags = torch.zeros(f.shape, dtype=torch.bool, device=f.device)
    for t in range(steps - 1, -1, -1):
        fs, bs = f[t], b[t]
        need = (x >> 20) >= fs          # x >= f << 20, safe at f = 4096
        words[t] = torch.where(need, x & 0xFFFF, 0)
        flags[t] = need
        x = torch.where(need, x >> 16, x)
        q = x // fs
        x = (q << PROB_BITS) + (x - q * fs) + bs
    return x, words, flags


def stripe_geometry(rows: int, cols: int, stripe_rows: int, n_lanes: int):
    """(n_stripes, steps, words per stripe): stripes of `stripe_rows` rows
    (the last one may be short; none is empty), each coded in
    ceil(stripe_rows * cols / n_lanes) steps, at most one 16-bit word a
    pixel."""
    n_stripes = -(-rows // stripe_rows)
    steps = -(-(stripe_rows * cols) // n_lanes)
    return n_stripes, steps, -(-(steps * n_lanes) // 2)


def _to_stripes(a: torch.Tensor, pad, n_stripes, stripe_rows, steps, N):
    """[B, rows, cols] -> [steps, B * S, N]: stripe s, step t, lane l holds
    pixel t*N + l of the stripe; pixels past the page are `pad`."""
    B, rows, cols = a.shape
    a = torch.nn.functional.pad(a, (0, 0, 0, n_stripes * stripe_rows - rows),
                                value=pad)
    a = a.reshape(B * n_stripes, stripe_rows * cols)
    a = torch.nn.functional.pad(a, (0, steps * N - stripe_rows * cols),
                                value=pad)
    return a.reshape(B * n_stripes, steps, N).transpose(0, 1)


def rans_stripes_plain(bits, ctx, p_used, *, stripe_rows: int,
                       n_lanes: int = N_LANES_DEFAULT):
    """Plain PyTorch K7: every stripe of a batch of pages coded at once.

    bits 0/1 [B, rows, cols]; ctx [B, rows, cols] context ids; p_used
    [B, 4096] P(bit == 1) * 4096 per context.  Returns (states int32
    [B, S, N], words int32 [B, S, Wcap], nbits int64 [B, S]): the
    decoder's initial states, each stripe's stream as MSB-first 32-bit
    words (uint32 bit patterns, zero past its end) and its length in bits."""
    B, rows, cols = bits.shape
    S, steps, wcap = stripe_geometry(rows, cols, stripe_rows, n_lanes)
    b64 = bits.to(torch.int64)
    p1 = torch.stack([table_lookup(t.to(torch.int64), c)
                      for t, c in zip(p_used, ctx)])
    f0 = PSCALE - p1
    f_px = torch.where(b64 == 1, p1, f0)
    b_px = torch.where(b64 == 1, f0, 0)
    lay = lambda a, pad: _to_stripes(a, pad, S, stripe_rows, steps, n_lanes)
    states, words, flags = rans_encode_plain(lay(f_px, PSCALE), lay(b_px, 0))
    # stream order: ascending (step, lane) within each stripe
    wv = words.transpose(0, 1).reshape(B * S, steps * n_lanes)
    fv = flags.transpose(0, 1).reshape(B * S, steps * n_lanes)
    sw, sb = pack_varlen(wv, fv.to(torch.int64) * 16, wcap)
    return (bitpack.to_i32(states).reshape(B, S, n_lanes),
            bitpack.to_i32(sw).reshape(B, S, wcap), sb.reshape(B, S))


def rans_encode(bits, ctx, p_used, *, stripe_rows: int,
                n_lanes: int = N_LANES_DEFAULT):
    """K7 over a batch of pages: (states, words, nbits) as
    ``rans_stripes_plain`` returns them.

    bits bool or uint8 [B, rows, cols]; ctx int16 [B, rows, cols]; p_used
    int16 [B, 4096].  CUDA tensors launch the kernel, CPU tensors run the
    plain version."""
    if not 1 <= n_lanes <= MAX_LANES:
        raise ValueError(f"n_lanes={n_lanes}: the payload takes 1 to "
                         f"{MAX_LANES} lanes")
    if bits.is_cuda:
        return _launch(bits, ctx, p_used, stripe_rows=stripe_rows,
                       n_lanes=n_lanes)
    if bits.device.type == "cpu":
        return rans_stripes_plain(bits, ctx, p_used, stripe_rows=stripe_rows,
                                  n_lanes=n_lanes)
    raise RuntimeError(f"K7 has no kernel for device {bits.device}")


def _launch(bits, ctx, p_used, *, stripe_rows: int, n_lanes: int):
    """Launch csrc/rans_encode.cu: one block per stripe."""
    B, rows, cols = bits.shape
    dev = bits.device
    if bits.dtype == torch.bool:
        bits = bits.view(torch.uint8)
    for name, t, dtype, shape in (("bits", bits, torch.uint8,
                                   (B, rows, cols)),
                                  ("ctx", ctx, torch.int16, (B, rows, cols)),
                                  ("p_used", p_used, torch.int16,
                                   (B, PSCALE))):
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"K7: {name} must be contiguous {dtype} {shape} "
                             f"on {dev}")
    if not 1 <= stripe_rows <= rows:
        raise ValueError(f"K7: stripe_rows={stripe_rows} for {rows} rows")
    S, steps, wcap = stripe_geometry(rows, cols, stripe_rows, n_lanes)
    states = torch.empty((B, S, n_lanes), dtype=torch.int32, device=dev)
    words = torch.zeros((B, S, wcap), dtype=torch.int32, device=dev)
    nbits = torch.empty((B, S), dtype=torch.int64, device=dev)
    scratch = torch.empty((B * S, steps * n_lanes), dtype=torch.int16,
                          device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    lib = _cuda.get_lib()
    _cuda.check(lib.bic_rans_encode(
        ptr(bits), ptr(ctx), ptr(p_used), ptr(scratch), ptr(states),
        ptr(words), ptr(nbits), B, rows, cols, S, stripe_rows, steps,
        n_lanes, _cuda.stream(dev)), "bic_rans_encode")
    _cuda.launches["rans_encode"] += 1
    return states, words, nbits


def pack_table(q: torch.Tensor, transmit: torch.Tensor):
    """The table section: the 6-bit codes of the transmitted contexts in
    ascending context order, as MSB-first words (int64 [768]) and their
    bit count."""
    return pack_varlen(q.to(torch.int64), transmit.to(torch.int64) * CODE_BITS,
                       TABLE_WORDS)


def rans_page_encode(bits, ctx, *, stripe_rows: int,
                     n_lanes: int = N_LANES_DEFAULT) -> dict:
    """The mode-2 payload's fields for one page (JAX ``rans_page_encode``
    :226), on the device of `bits`.

    bits 0/1 [rows, cols]; ctx [rows, cols] from ``compress.scab_ctx_map``.
    Returns transmit, q_default, states [S, N], words [S, Wcap], bits [S]
    (stream bit counts), tab_words, tab_bits and n_transmit, as tensors."""
    ones, total = count_contexts(ctx, bits)
    q, transmit, q_def, p_used = build_table(ones, total)
    states, words, nbits = rans_encode(
        bits[None], ctx.to(torch.int16)[None],
        p_used.to(torch.int16)[None], stripe_rows=stripe_rows,
        n_lanes=n_lanes)
    tab_words, tab_bits = pack_table(q, transmit)
    return dict(transmit=transmit, q_default=q_def, states=states[0],
                words=words[0], bits=nbits[0], tab_words=tab_words,
                tab_bits=tab_bits, n_transmit=transmit.sum())
