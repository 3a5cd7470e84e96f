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
one CUDA block per stripe, whose chain warps walk the steps backwards with
the state update alone on each lane's dependent line (producer warps stage
the inputs, the divide is a multiply-high by ``div_magic``'s constants, a
lane stores its words at their (step, lane) slots and flags them), then
the block writes the stripe's word stream in order.  For CPU tensors it
runs ``rans_stripes_plain``: the per-pixel (f, b) in the stripe layout,
the reverse loop ``rans_encode_plain`` (JAX ``rans_encode_scan`` without
its unroll) and ``bitstream.pack_varlen`` of the emitted words in stream
order.  The kernel's two new pieces of arithmetic have plain twins that
the CPU tests hold against those: ``div_magic`` (the divisor constants)
and ``stream_order_plain`` (its stream-order pass, over the flag words
``step_flag_words`` packs).

The context counts are one integer ``torch.bincount`` (JAX's MXU one-hot
histogram and its 2^24 float32 bound are a TPU workaround), and the table
lookup a plain gather.  JAX's ``count_contexts`` takes a ``mask`` that no
caller passes; it is left out.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.profiling import span
from . import _cuda, bitpack
from .bitpack import U32, popcount
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
    """(q [..., 4096] int32, transmit [..., 4096] bool, q_default [...]
    int32, p_used [..., 4096] int32), per page of a [..., 4096] batch.

    A context is transmitted iff its own quantized probability saves more
    than its 6-bit code and ~6 bits of bitmap over the page-wide default.
    The default's counts are summed as integers (JAX sums them in float32,
    the same value for pages below 2^24 pixels)."""
    q_def = quantize_probs(ones.sum(-1), total.sum(-1))
    ones = ones.to(torch.float32)
    total = total.to(torch.float32)
    zeros = total - ones
    q = quantize_probs(ones, total)
    lut = torch.from_numpy(LOGIT64).to(q.device)
    p_own = lut[q]
    p_def = lut[q_def].unsqueeze(-1)
    save = _cost_bits(ones, zeros, p_def) - _cost_bits(ones, zeros, p_own)
    transmit = (total > 0) & (save > CODE_BITS + 6.0)
    p_used = torch.where(transmit, p_own, p_def)
    return q, transmit, q_def, p_used


def count_contexts(ctx: torch.Tensor, bits: torch.Tensor):
    """(ones [..., 4096], total [..., 4096]) int64 per-context bit counts of
    each page of ctx, bits [..., rows, cols]: one ``bincount`` of
    page * 8192 + ctx * 2 + bit."""
    lead = ctx.shape[:-2]
    B = int(np.prod(lead, dtype=np.int64))
    page = torch.arange(B, device=ctx.device)[:, None] * (2 * PSCALE)
    v = torch.bincount((page + ctx.reshape(B, -1).to(torch.int64) * 2
                        + bits.reshape(B, -1).to(torch.int64)).reshape(-1),
                       minlength=B * 2 * PSCALE).reshape(lead + (PSCALE, 2))
    return v[..., 1], v[..., 0] + v[..., 1]


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


def _stripe_loop(bits, ctx, p_used, stripe_rows: int, n_lanes: int):
    """The reverse loop over every stripe of a batch of pages:
    ``rans_encode_plain`` of the per-pixel (f, b) in the stripe layout
    (states, words and flags over [steps, B * S, N])."""
    B, rows, cols = bits.shape
    S, steps, _ = stripe_geometry(rows, cols, stripe_rows, n_lanes)
    b64 = bits.to(torch.int64)
    p1 = torch.stack([table_lookup(t.to(torch.int64), c)
                      for t, c in zip(p_used, ctx)])
    f0 = PSCALE - p1
    f_px = torch.where(b64 == 1, p1, f0)
    b_px = torch.where(b64 == 1, f0, 0)
    lay = lambda a, pad: _to_stripes(a, pad, S, stripe_rows, steps, n_lanes)
    return rans_encode_plain(lay(f_px, PSCALE), lay(b_px, 0))


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
    states, words, flags = _stripe_loop(bits, ctx, p_used, stripe_rows,
                                        n_lanes)
    # stream order: ascending (step, lane) within each stripe
    wv = words.transpose(0, 1).reshape(B * S, steps * n_lanes)
    fv = flags.transpose(0, 1).reshape(B * S, steps * n_lanes)
    sw, sb = pack_varlen(wv, fv.to(torch.int64) * 16, wcap)
    return (bitpack.to_i32(states).reshape(B, S, n_lanes),
            bitpack.to_i32(sw).reshape(B, S, wcap), sb.reshape(B, S))


def rans_stripes_twin(bits, ctx, p_used, *, stripe_rows: int,
                      n_lanes: int = N_LANES_DEFAULT):
    """``rans_stripes_plain`` with the kernel's stream-order pass in place
    of ``pack_varlen``: the plain loop's words and flags through
    ``step_flag_words`` and ``stream_order_plain``.  Same outputs."""
    B, rows, cols = bits.shape
    S, _, wcap = stripe_geometry(rows, cols, stripe_rows, n_lanes)
    states, words, flags = _stripe_loop(bits, ctx, p_used, stripe_rows,
                                        n_lanes)
    sw, sb = stream_order_plain(words.transpose(0, 1),
                                step_flag_words(flags))
    return (bitpack.to_i32(states).reshape(B, S, n_lanes),
            sw.reshape(B, S, wcap), sb.reshape(B, S))


MAGIC_RANGE = 1 << 20               # x < f * 2^20 before the divide


def _magic_one(f: int) -> tuple[int, int, int]:
    """(m, s, a) for one f: the first s whose round-up (a = 0, m =
    ceil(2^k / f)) or round-down (a = 1, m = floor(2^k / f), y + 1) multiply
    is exact on y < f * (2^20 + 1), k = 32 + s, by the method's error
    bound: round-up errs first at the largest y (y * e < 2^k, e = m*f -
    2^k), round-down at the largest multiple of f ((2^20 * f + 1) * e' <=
    2^k, e' = 2^k - m*f > 0)."""
    top = f * (MAGIC_RANGE + 1) - 1
    for s in range(32):
        k = 32 + s
        m = -(-(1 << k) // f)
        if m < 1 << 32 and top * (m * f - (1 << k)) < 1 << k:
            return m, s, 0
        m = min((1 << k) // f, (1 << 32) - 1)
        e = (1 << k) - m * f
        if e > 0 and (MAGIC_RANGE * f + 1) * e <= 1 << k:
            return m, s, 1
    raise ValueError(f"no 32-bit divisor constants for f={f}")


def div_magic(f) -> np.ndarray:
    """K7's divisor constants: int64 [..., 3] rows (m, s, a) for f in
    1..4096 with ((y + a) * m) >> (32 + s) == y // f for every
    0 <= y < f * (2^20 + 1): the state before the divide (x < f * 2^20)
    plus bit * f, which folds the cdf base into the quotient."""
    f = np.asarray(f, dtype=np.int64)
    rows = [_magic_one(int(v)) for v in f.reshape(-1)]
    return np.asarray(rows, dtype=np.int64).reshape(f.shape + (3,))


_MAGIC: dict = {}


def magic_table(dev) -> torch.Tensor:
    """K7's table on `dev`, built once: int32 [4096, 2] bit patterns of
    (m, s | a << 5) for f = 1..4096."""
    dev = torch.device(dev)
    if dev not in _MAGIC:
        m, s, a = div_magic(np.arange(1, PSCALE + 1)).T
        tab = np.stack([m, s | a << 5], axis=1).astype(np.uint32)
        _MAGIC[dev] = torch.from_numpy(tab.view(np.int32)).to(dev)
    return _MAGIC[dev]


def step_flag_words(flags: torch.Tensor) -> torch.Tensor:
    """The kernel's flag words from step flags bool [steps, S, N]: int64
    [S, G, Np] with bit u of [s, g, l] set iff lane l of stripe s emitted
    at step 32g + u (G = ceil(steps / 32), lanes rounded up to whole warps
    of 32, pads 0)."""
    steps, S, N = flags.shape
    G, Np = -(-steps // 32), -(-N // 32) * 32
    f = torch.zeros((G * 32, S, Np), dtype=torch.int64, device=flags.device)
    f[:steps, :, :N] = flags.to(torch.int64)
    u = torch.arange(32, device=flags.device).reshape(1, 32, 1, 1)
    return (f.reshape(G, 32, S, Np) << u).sum(1).permute(1, 0, 2)


_T_MASKS = (0x0000FFFF, 0x00FF00FF, 0x0F0F0F0F, 0x33333333, 0x55555555)


def transpose32_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's warp transpose of 32 x 32 bits over the last dim (int64
    of uint32 values): row j's bit u becomes row u's bit j, by the same
    five block swaps (a shuffle each on the card)."""
    j = torch.arange(32, device=x.device)
    for m, k in zip(_T_MASKS, (16, 8, 4, 2, 1)):
        o = x[..., j ^ k]
        x = torch.where((j & k) != 0, (x & (m ^ U32)) | ((o >> k) & m),
                        (x & m) | ((o & m) << k))
    return x


def stream_order_plain(words: torch.Tensor, fw: torch.Tensor):
    """Plain twin of K7's stream-order pass: (stream words int32 [S, Wcap],
    nbits int64 [S]) from each lane's word at each step, words int64 [S,
    steps, N] (read only where flagged), and the flag words fw int64 [S, G,
    Np] of ``step_flag_words``.  As on the card: the groups' counts and
    their exclusive scan, the flag bits transposed per 32 lanes so that
    step u holds its emitting lanes, and stream word p written as half p ^ 1
    of the little-endian uint32 words (the high half when p is even)."""
    S, steps, N = words.shape
    G, Np = fw.shape[1], fw.shape[2]
    nc, wcap = Np // 32, -(-(steps * N) // 2)
    cnt = popcount(fw).sum(-1)                            # [S, G]
    pg = torch.cumsum(cnt, 1) - cnt
    M = transpose32_plain(fw.reshape(S, G, nc, 32))       # [S, G, c, u]
    pm = popcount(M)
    e = pm.sum(2)                                         # [S, G, u]
    before = (torch.cumsum(e, -1) - e)[:, :, None] + torch.cumsum(pm, 2) - pm
    j = torch.arange(32, device=words.device)
    on = ((M[..., None] >> j) & 1).bool()                 # [S, G, c, u, j]
    pos = (pg[:, :, None, None, None] + before[..., None]
           + popcount(M[..., None] & ((1 << j) - 1)))
    wpad = torch.zeros((S, G * 32, Np), dtype=torch.int64,
                       device=words.device)
    wpad[:, :steps, :N] = words
    wv = wpad.reshape(S, G, 32, nc, 32).permute(0, 1, 3, 2, 4)
    stripe = torch.arange(S, device=words.device).reshape(S, 1, 1, 1, 1)
    half = torch.zeros((S, 2 * wcap), dtype=torch.int64, device=words.device)
    half[stripe.expand_as(pos)[on], pos[on] ^ 1] = wv[on] & 0xFFFF
    stream = half[:, 1::2] << 16 | half[:, 0::2]
    return bitpack.to_i32(stream), 16 * cnt.sum(1)


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
    """Launch csrc/rans_encode.cu: one block per stripe (chain warps for
    the lanes, producer warps for their inputs)."""
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
    # a word slot per (step, lane), and a flag word per 32 steps and lane
    scratch = torch.empty((B * S, steps * n_lanes), dtype=torch.int16,
                          device=dev)
    flags = torch.empty((B * S, -(-steps // 32) * -(-n_lanes // 32) * 32),
                        dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    lib = _cuda.get_lib()
    _cuda.check(lib.bic_rans_encode(
        ptr(bits), ptr(ctx), ptr(p_used), ptr(magic_table(dev)),
        ptr(scratch), ptr(flags), ptr(states), ptr(words), ptr(nbits), B,
        rows, cols, S, stripe_rows, steps, n_lanes, _cuda.stream(dev)),
        "bic_rans_encode")
    _cuda.launches["rans_encode"] += 1
    return states, words, nbits


def pack_table(q: torch.Tensor, transmit: torch.Tensor):
    """The table section of each page of a [..., 4096] batch: the 6-bit
    codes of the transmitted contexts in ascending context order, as
    MSB-first words (int64 [..., 768]) and their bit count."""
    return pack_varlen(q.to(torch.int64), transmit.to(torch.int64) * CODE_BITS,
                       TABLE_WORDS)


def rans_stack_encode(bits, ctx, *, stripe_rows: int,
                      n_lanes: int = N_LANES_DEFAULT) -> dict:
    """The mode-2 payload's fields for a stack of P pages of one shape (JAX
    vmaps ``rans_page_encode`` over a bitplane stack), on the device of
    `bits`: the counts and tables batched [P, 4096] and one K7 launch for
    every stripe of every page.

    bits 0/1 [P, rows, cols]; ctx [P, rows, cols] from
    ``compress.scab_ctx_map``.  Returns transmit [P, 4096], q_default [P],
    states [P, S, N], words [P, S, Wcap], bits [P, S] (stream bit counts),
    tab_words [P, 768], tab_bits [P] and n_transmit [P], as tensors.
    Spans: ``rans.counts`` (``bincount`` sizes its output from the
    largest key, so the host waits there for the work queued before it),
    ``rans.table``, ``rans.k7`` and ``rans.pack_table``."""
    with span("rans.counts"):
        ones, total = count_contexts(ctx, bits)
    with span("rans.table"):
        q, transmit, q_def, p_used = build_table(ones, total)
    with span("rans.k7"):
        states, words, nbits = rans_encode(
            bits, ctx.to(torch.int16), p_used.to(torch.int16),
            stripe_rows=stripe_rows, n_lanes=n_lanes)
    with span("rans.pack_table"):
        tab_words, tab_bits = pack_table(q, transmit)
    return dict(transmit=transmit, q_default=q_def, states=states,
                words=words, bits=nbits, tab_words=tab_words,
                tab_bits=tab_bits, n_transmit=transmit.sum(-1))


def rans_page_encode(bits, ctx, *, stripe_rows: int,
                     n_lanes: int = N_LANES_DEFAULT) -> dict:
    """The mode-2 payload's fields for one page (JAX ``rans_page_encode``
    :226): ``rans_stack_encode`` of a stack of one, without its batch dim.

    bits 0/1 [rows, cols]; ctx [rows, cols] from ``compress.scab_ctx_map``."""
    out = rans_stack_encode(bits[None], ctx[None], stripe_rows=stripe_rows,
                            n_lanes=n_lanes)
    return {k: v[0] for k, v in out.items()}
