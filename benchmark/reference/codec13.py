"""Plain reference of codec 13's payload mode 2 (static table, rANS).

Written from the format with no code of the program: numpy only.

  * stripes of ceil(rows / n) rows, n = the configured count or
    max(1, min(16, rows // 128)), as many as that takes;
  * the 12-bit context of a pixel (10-bit for template 10): rows r-2 and
    r-1 and the pixels left of it on row r, reads outside the page or above
    the stripe's top are 0;
  * per context the count of ones and of pixels; each gets the 6-bit code
    of the nearest of 64 logit-spaced probabilities to (ones + 1/2) /
    (total + 1), in float32; a context is sent when its own code saves
    more than 12 bits over the page's default code;
  * each stripe is coded by N interleaved rANS lanes (32-bit state from
    2^16, 16-bit words, 12-bit frequencies), lane l taking pixels t*N + l
    in reverse, so that the decoder reads the words forwards.

Layout after the BIC1 header: u8 tmpl | u8 2 | u16 n_stripes | i32
stripe_rows | u8 n_lanes | u8 q_default | u16 n_transmit | u8 bitmap mode
(0 raw, 1 Rice gaps) | u8 rice_k | u16 bitmap bytes | bitmap | 6-bit codes
| u32 stripe bytes[n_stripes] | per stripe: u32 LE lane states, then its
u16 big-endian words.
"""

from __future__ import annotations

import struct

import numpy as np

from . import codec8

PSCALE = 4096
CODE_BITS = 6
LOGIT64 = np.asarray([
    1, 2, 2, 3, 4, 5, 6, 8, 10, 13, 17, 22, 29, 37, 48, 61,
    78, 101, 129, 164, 209, 266, 337, 424, 531, 659, 812, 990,
    1193, 1419, 1663, 1918, 2178, 2433, 2677, 2903, 3106, 3284,
    3437, 3565, 3672, 3759, 3830, 3887, 3932, 3967, 3995, 4018,
    4035, 4048, 4059, 4067, 4074, 4079, 4083, 4086, 4088, 4090,
    4091, 4092, 4093, 4094, 4094, 4095], dtype=np.int64)

# (row offset, column offset) of each context bit, most significant first
TEMPLATES = {
    10: [(-2, -1), (-2, 0), (-2, 1), (-1, -2), (-1, -1), (-1, 0), (-1, 1),
         (-1, 2), (0, -2), (0, -1)],
    12: [(-2, -1), (-2, 0), (-2, 1), (-1, -2), (-1, -1), (-1, 0), (-1, 1),
         (-1, 2), (-1, 3), (0, -3), (0, -2), (0, -1)],
}


def stripes(rows: int, n_stripes: int | None) -> tuple[int, int]:
    """(n_stripes, stripe_rows) of a page."""
    n = n_stripes or max(1, min(16, rows // 128))
    sr = -(-rows // min(n, rows))
    return -(-rows // sr), sr


def contexts(img: np.ndarray, tmpl: int, stripe_rows: int) -> np.ndarray:
    """int64 [rows, cols] context id of every pixel."""
    rows, cols = img.shape
    padded = np.zeros((rows + 2, cols + 6), dtype=np.int64)
    padded[2:, 3:3 + cols] = img
    r = np.arange(rows)[:, None]
    top = (r // stripe_rows) * stripe_rows
    ctx = np.zeros((rows, cols), dtype=np.int64)
    tm = TEMPLATES[tmpl]
    for i, (dr, dc) in enumerate(tm):
        v = padded[2 + dr:2 + dr + rows, 3 + dc:3 + dc + cols]
        ctx |= np.where(r + dr >= top, v, 0) << (len(tm) - 1 - i)
    return ctx


def quantize(ones, total) -> np.ndarray:
    """6-bit codes: the nearest logit-spaced code to (ones + 1/2) /
    (total + 1), in float32."""
    f = np.float32
    p = (np.asarray(ones, f) + f(0.5)) / (np.asarray(total, f) + f(1.0))
    logit = np.log(p / (f(1.0) - p))
    q = np.round((np.clip(logit, f(-8.0), f(8.0)) + f(8.0))
                 * f(63.0 / 16.0))
    return np.clip(q, 0, 63).astype(np.int64)


def table(ones: np.ndarray, total: np.ndarray):
    """(q, transmit, q_default, p_used) of a page's counts."""
    f = np.float32
    q_def = int(quantize(ones.sum(), total.sum()))
    q = quantize(ones, total)
    o, z = ones.astype(f), (total - ones).astype(f)

    def cost(p12):
        pf = np.asarray(p12, f) / f(PSCALE)
        return -(o * np.log2(pf) + z * np.log2(f(1.0) - pf))

    save = cost(LOGIT64[q_def]) - cost(LOGIT64[q])
    transmit = (total > 0) & (save > f(CODE_BITS + 6.0))
    p_used = np.where(transmit, LOGIT64[q], LOGIT64[q_def])
    return q, transmit, q_def, p_used


def rans_stripe_streams(img, ctx, p_used, stripe_rows: int, n_lanes: int):
    """(states [S, N], words: list of uint16 arrays per stripe)."""
    rows, cols = img.shape
    S = -(-rows // stripe_rows)
    per = stripe_rows * cols
    steps = -(-per // n_lanes)
    p1 = p_used[ctx]
    f = np.where(img, p1, PSCALE - p1)
    b = np.where(img, PSCALE - p1, 0)
    fs = np.full(S * per, PSCALE, dtype=np.int64)   # padding: a no-op
    bs = np.zeros(S * per, dtype=np.int64)
    fs[:rows * cols], bs[:rows * cols] = f.reshape(-1), b.reshape(-1)
    pad = steps * n_lanes - per
    fs = np.pad(fs.reshape(S, per), ((0, 0), (0, pad)), constant_values=PSCALE)
    bs = np.pad(bs.reshape(S, per), ((0, 0), (0, pad)))
    fs = fs.reshape(S, steps, n_lanes)
    bs = bs.reshape(S, steps, n_lanes)
    x = np.full((S, n_lanes), 1 << 16, dtype=np.int64)
    words = np.zeros((S, steps, n_lanes), dtype=np.int64)
    flags = np.zeros((S, steps, n_lanes), dtype=bool)
    for t in range(steps - 1, -1, -1):
        ft, bt = fs[:, t], bs[:, t]
        need = x >= (ft << 20)
        words[:, t] = x & 0xFFFF
        flags[:, t] = need
        x = np.where(need, x >> 16, x)
        x = ((x // ft) << 12) + x % ft + bt
    return x, [words[s][flags[s]].astype(np.uint16) for s in range(S)]


def _rice(gaps: np.ndarray, k: int) -> bytes:
    bits = "".join((format(int(g) & ((1 << k) - 1), f"0{k}b") if k else "")
                   + "0" * (int(g) >> k) + "1" for g in gaps)
    return codec8._bytes_of(bits)


def body(img: np.ndarray, *, tmpl: int = 12, n_stripes: int | None = None,
         n_lanes: int = 32) -> bytes:
    """The mode-2 payload of a page."""
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    S, sr = stripes(rows, n_stripes)
    ctx = contexts(img, tmpl, sr)
    total = np.bincount(ctx.reshape(-1), minlength=PSCALE)
    ones = np.bincount(ctx.reshape(-1), weights=img.reshape(-1),
                       minlength=PSCALE).astype(np.int64)
    q, transmit, q_def, p_used = table(ones, total)
    states, streams = rans_stripe_streams(img, ctx, p_used, sr, n_lanes)
    ids = np.flatnonzero(transmit)
    gaps = np.diff(np.concatenate([[-1], ids])) - 1
    nbits = [(k + 1) * gaps.size + int((gaps >> k).sum()) for k in range(13)]
    k = int(np.argmin(nbits))
    if ids.size and -(-nbits[k] // 8) < 512:
        bm_mode, bm = 1, _rice(gaps, k)
    else:
        bm_mode, k, bm = 0, 0, np.packbits(transmit).tobytes()
    codes = "".join(format(int(v), "06b") for v in q[ids])
    out = bytearray(struct.pack("<BBHi", tmpl, 2, S, sr))
    out += struct.pack("<BBH", n_lanes, q_def, ids.size)
    out += struct.pack("<BBH", bm_mode, k, len(bm)) + bm
    out += codec8._bytes_of(codes)
    parts = [states[s].astype("<u4").tobytes()
             + streams[s].astype(">u2").tobytes() for s in range(S)]
    for p in parts:
        out += struct.pack("<I", len(p))
    return bytes(out + b"".join(parts))


def encode(img: np.ndarray, *, W: int = 16, T: int | None = None,
           R: int = 128, n_lanes: int = 32) -> bytes:
    """The whole codec-13 mode-2 stream: BIC1 header (codec 13; W picks
    the template when it is 10 or 12, else 12; T the stripe count) and the
    payload."""
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    tmpl = W if W in (10, 12) else 12
    return (codec8.header(13, False, W, rows, cols, T or 0, R,
                          codec8.image_crc(img))
            + body(img, tmpl=tmpl, n_stripes=T, n_lanes=n_lanes))


def stream(page: np.ndarray, config: dict, device=None) -> bytes:
    """The stream of a page under a configuration's settings (numpy on the
    host; `device` is not used)."""
    return encode(page, W=config["W"], T=config["T"], R=config["R"],
                  n_lanes=config["n_lanes"])


def word_bytes(stream: bytes) -> int:
    """Bytes of the rANS words in a mode-2 stream (its stripes' bytes less
    the lane states)."""
    b = stream[28:]
    n_stripes = struct.unpack("<H", b[2:4])[0]
    n_lanes, n_tr = b[8], struct.unpack("<H", b[10:12])[0]
    bm_len = struct.unpack("<H", b[14:16])[0]
    off = 16 + bm_len + (n_tr * CODE_BITS + 7) // 8
    lens = struct.unpack(f"<{n_stripes}I", b[off:off + 4 * n_stripes])
    return sum(lens) - 4 * n_lanes * n_stripes
