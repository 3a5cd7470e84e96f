"""BIC1 container: parameters, header, every codec on the host, decode,
and the grayscale (BICG) and color (BICC) containers.

Counterpart of ``binary_image_compression_tpu/models/codec.py``:
``CodecParams`` with ``resolved_T``, ``MAGIC``, ``HEADER_LEN``,
``VALID_CODECS``, ``image_crc``, ``_header``, and ``encode`` and ``decode``
for every codec of ``VALID_CODECS`` (:260-295, :415-457):

* the windowed codecs 4/6/7/8, both modes: the native host encoder
  (``_encode_windowed``'s native branch :308-321); decoded by the shared
  native decoder ``bic_decode_windowed`` or, for pages past its bound, the
  numpy ``_decode_windowed`` (:459, with ``window_candidates`` :65 and
  ``_unmed`` :188);
* codec 1, the full-prior-area tile codec: ``c1_candidate_count``,
  ``_c1_rank_to_pos``, ``_c1_tables`` (``_c1_sums``), ``_c1_corr`` and
  ``_search_c1``
  (:92-178) and the numpy tile loop of ``_encode_windowed`` (:322-406; the
  native encoder does not take codec 1), decoded by ``_decode_windowed``;
* codecs 2 and 3, the dictionary codecs (``_encode_dict`` :515,
  ``_decode_dict`` :586), numpy;
* codec 10, full-image MED and adaptive exp-Golomb runs (``_medrle_runs``
  :635, ``_encode_medrle`` :650, ``_decode_medrle_payload`` :672), its runs
  coded by the native coder;
* codec 11, the learned-dictionary (BSVD) patch codec (``_encode_bsvd``
  :847, split here into the learning step, on the device or by the
  reference replay ``bsvd_ref``, and ``_write_bsvd``; ``_decode_bsvd``
  :908, numpy);
* codec 12, context-adaptive binary arithmetic coding (``_encode_cabic``
  :953, ``_decode_cabic`` :978), native;
* codec 13, the stripe-parallel context-adaptive range coder
  (``scab_defaults`` :1000, ``_encode_scab`` :1036, ``_decode_scab``
  :1086, ``_decode_scab_rans`` :1121), native.

Codecs 4/7/8 in causal mode, codec 8 in strict mode and codec 13 with its
context map on the device are also encoded on the device by
``models/compress``, to the same bytes.  The JAX package's pure-Python
range coders and its ``_EGStream`` are its fallback for a missing native
library, which the port does not have, so they are not ported.

Grayscale (``encode_pgm`` :749, ``decode_pgm`` :808) and color
(``encode_ppm`` :1221, ``decode_ppm`` :1238): one BIC1 stream per bitplane,
after an optional gray code.  The backends are JAX's four under the port's
names, ``device`` choosing the card or the CPU:

    port               JAX                    the planes
    "host"             "host"                 codec.encode per plane (the
                                              default: the smaller of codec
                                              13 and codec 10)
    "device"           "tpu"                  codec 10: MED on the device,
                                              native EG runs
    "device-assembly"  "tpu-device-assembly"  codec 10: MED and kernel K8
                                              on the device
    "device-rans"      "tpu-rans"             codec 13 mode 2: the stack
                                              through one K7 launch

Container: magic "BIC1" | u32 crc32 of the packed image | u8 codec | u8
flags (bit0 strict) | u16 W | u32 rows | u32 cols | u32 T | u32 R | payload.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from .. import native
from ..ops._cuda import resolve_device
from ..ops.bitstream import (BitReader, BitWriter, enum_decode, enum_encode,
                             enum_nbits, golomb_decode, golomb_encode)
from ..ops.entropy import GolombCoder

MAGIC = b"BIC1"
HEADER_LEN = 28
VALID_CODECS = (1, 2, 3, 4, 6, 7, 8, 10, 11, 12, 13)
WINDOWED_CODECS = (4, 6, 7, 8)      # what native.encode_windowed writes
DICT_CODECS = (2, 3)
# the codecs with W x W tiles, whose W is bounded to [1, 64]
TILED_CODECS = (1, 2, 3, 4, 6, 7, 8, 11)
MEDRLE_CODEC = 10
BSVD_CODEC = 11
CABIC_CODEC = 12
SCAB_CODEC = 13
# the largest page a header may declare (JAX codec.py:425)
MAX_PIXELS = 2 ** 31
# the largest page bic_decode_windowed takes (native/bic_native.cpp:593);
# larger windowed pages decode through the numpy _decode_windowed
NATIVE_MAX_PIXELS = 2 ** 30


@dataclass
class CodecParams:
    codec: int = 8
    W: int = 16
    T: int | None = None
    R: int = 128
    strict: bool = True

    def resolved_T(self) -> int:
        if self.T is not None:
            return self.T
        if self.codec == 8:  # compress8's auto threshold (compress8:72-74)
            M = self.W * self.W
            return int(math.ceil(math.log2((2 * self.R + 1) * self.R))
                       // math.ceil(math.log2(M)))
        if self.codec == 3:  # compress3's default (compress3_test.cpp:55)
            return self.W * self.W // 8
        return 0


def params_from_jax(p) -> CodecParams:
    """The port's CodecParams from a JAX-package CodecParams, read by
    attribute (the codec-8 path has no weights: parameters are all that
    crosses over)."""
    return CodecParams(codec=p.codec, W=p.W, T=p.T, R=p.R, strict=p.strict)


def image_crc(img: np.ndarray) -> int:
    return zlib.crc32(np.packbits(np.asarray(img, dtype=bool)).tobytes())


def _header(params, rows, cols, crc: int = 0) -> bytes:
    flags = 1 if params.strict else 0
    return MAGIC + struct.pack("<IBBHIIII", crc, params.codec, flags,
                               params.W, rows, cols, params.resolved_T(),
                               params.R)


def _check_W(params) -> None:
    """The decoder and the native runtime take W in [1, 64] (JAX
    codec.py:269 and compress.py:40): every encoder checks it."""
    if not 1 <= params.W <= 64:
        raise ValueError(f"tile width W={params.W} out of range [1, 64] "
                         f"for codec {params.codec}")


def encode(img: np.ndarray, params: CodecParams | None = None, *,
           device="cuda", learn_backend: str | None = None) -> bytes:
    """Encode one page with any codec of ``VALID_CODECS`` on the host, as
    JAX's ``codec.encode`` does (module docstring).  Codec 11 learns its
    dictionary on `device` (cuda, or cpu for the plain kernels), or, with
    learn_backend="ref", by the reference's rand48 replay (``bsvd_ref``,
    JAX's bytes exactly); no other codec touches the device.  Codec 1 has
    no strict variant: its stream is written in causal mode, as in JAX."""
    params = params or CodecParams()
    if params.codec not in VALID_CODECS:
        raise ValueError(f"unknown codec id {params.codec}; "
                         f"valid: {VALID_CODECS}")
    if params.codec in TILED_CODECS:
        _check_W(params)
    img = np.asarray(img, dtype=bool)
    if params.codec == MEDRLE_CODEC:
        return _encode_medrle(img)
    if params.codec == BSVD_CODEC:
        return _encode_bsvd(img, params, learn_backend=learn_backend or device)
    if params.codec == CABIC_CODEC:
        return _encode_cabic(img, params)
    if params.codec == SCAB_CODEC:
        return _encode_scab(img, params)
    if params.codec in DICT_CODECS:
        return _encode_dict(img, params)
    if params.codec == 1:
        # compress1 searches the original image and never substitutes
        # residuals (compress_test.cpp): there is no strict variant
        return _encode_c1(img, dataclasses.replace(params, strict=False))
    return _encode_windowed(img, params)


def _encode_windowed(img, params) -> bytes:
    """Codecs 4/6/7/8 in either mode: the native host encoder
    (``bic_encode_windowed``)."""
    hdr = _header(params, *img.shape, image_crc(img))
    return native.encode_windowed(img, hdr, params.codec, params.strict,
                                  params.W, params.resolved_T(), params.R)


def _encode_bsvd(img, params, *, K=64, learn_backend="cuda",
                 seed=34503498) -> bytes:
    """Learn a GF(2) dictionary over the page's W x W patches, then write
    the stream (``_write_bsvd``).  learn_backend: a device (``bsvd.learn``
    there, random-centroid init from `seed` by a torch.Generator) or "ref"
    (``bsvd_ref``: the reference's rand48 random centroids and its
    traditional loop, JAX :875-882)."""
    if learn_backend == "ref":
        from . import bsvd_ref
        W = params.W
        rows, cols = img.shape
        ny, nx = -(-rows // W), -(-cols // W)
        grid = np.zeros((ny * W, nx * W), dtype=bool)
        grid[:rows, :cols] = img
        X = grid.reshape(ny, W, nx, W).swapaxes(1, 2).reshape(ny * nx, W * W)
        bsvd_ref.reset_rng(seed)
        D = np.zeros((K, W * W), dtype=bool)
        A = np.zeros((X.shape[0], K), dtype=bool)
        bsvd_ref.initialize_random_centroids(X, D, A)
        E = np.zeros_like(X)
        bsvd_ref.learn_traditional(X, E, D, A, bsvd_ref.update_coefficients,
                                   bsvd_ref.update_dictionary_steepest)
        return _write_bsvd(img, params, E, D, A, K)
    import torch

    from . import bsvd
    dev = resolve_device(learn_backend)
    X = bsvd.patchify_to_rows(torch.from_numpy(img).to(dev), params.W)
    E, D, A, _ = bsvd.learn(X, K=K, init="random_centroids", seed=seed)
    E, D, A = bsvd.state_to_numpy(E, D, A)
    return _write_bsvd(img, params, E, D, A, K)


def _write_bsvd(img, params, E, D, A, K) -> bytes:
    """The codec-11 stream of a learned state (JAX codec.py:884-905):
    header | K:u16 | per atom: Golomb weight (ctx d) + enum rank | per
    patch: Golomb #coefs (ctx c), enum rank of the coefficient set over
    C(K, k_i), Golomb residual weight (ctx r), enum residual rank."""
    img = np.asarray(img, dtype=bool)
    E, D, A = (np.asarray(x, dtype=bool) for x in (E, D, A))
    rows, cols = img.shape
    w = BitWriter()
    hdr = _header(params, rows, cols, image_crc(img))
    w.write_bits(int.from_bytes(hdr, "big"), len(hdr) * 8)
    w.write_bits(K, 16)
    gd = GolombCoder()
    for k in range(K):
        wt = int(D[k].sum())
        golomb_encode(w, wt, gd.k)
        gd.code_sample(wt)
        enum_encode(w, D[k])
    gc, gr = GolombCoder(), GolombCoder()
    for i in range(E.shape[0]):
        nc = int(A[i].sum())
        golomb_encode(w, nc, gc.k)
        gc.code_sample(nc)
        enum_encode(w, A[i])
        wt = int(E[i].sum())
        golomb_encode(w, wt, gr.k)
        gr.code_sample(wt)
        enum_encode(w, E[i])
    return w.getvalue()


def _decode_bsvd(r: BitReader, W, rows, cols) -> np.ndarray:
    """Inverse of ``_write_bsvd``: each patch is (coefs * D mod 2) ^ E."""
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    K = r.read_bits(16)
    gd = GolombCoder()
    D = np.zeros((K, M), dtype=bool)
    for k in range(K):
        wt = golomb_decode(r, gd.k)
        gd.code_sample(wt)
        D[k] = enum_decode(r, M, wt)
    Dint = D.astype(np.int64)
    gc, gr = GolombCoder(), GolombCoder()
    out = np.zeros((ny * W, nx * W), dtype=bool)
    for ti in range(ny):
        for tj in range(nx):
            nc = golomb_decode(r, gc.k)
            gc.code_sample(nc)
            coefs = enum_decode(r, K, nc)
            wt = golomb_decode(r, gr.k)
            gr.code_sample(wt)
            E = enum_decode(r, M, wt)
            patch = ((coefs.astype(np.int64) @ Dint) % 2 == 1) ^ E
            out[ti * W:(ti + 1) * W, tj * W:(tj + 1) * W] = \
                patch.reshape(W, W)
    return out[:rows, :cols]


def scab_defaults(params: CodecParams, rows: int) -> tuple[int, int]:
    """(template bits, n_stripes) for codec 13: params.W picks the template
    when it is 10 or 12 (default 12); params.T the stripe count (0 or None:
    one stripe per 128 rows, clamped to [1, 16]), at most one per row."""
    tmpl = params.W if params.W in (10, 12) else 12
    n_stripes = params.T if params.T else max(1, min(16, rows // 128))
    return tmpl, min(n_stripes, rows)


def scab_stripes(params: CodecParams, rows: int) -> tuple[int, int, int]:
    """(template bits, n_stripes, stripe_rows) of a codec-13 page: stripes
    of ceil(rows / n_stripes) rows, and as many as that takes, so that no
    stripe is empty (the native coder's rule, bic_native.cpp
    bic_scab_encode)."""
    tmpl, n_stripes = scab_defaults(params, rows)
    stripe_rows = -(-rows // n_stripes)
    return tmpl, -(-rows // stripe_rows), stripe_rows


def _encode_scab(img, params, ctx_pre=None) -> bytes:
    """Codec 13, payload mode 1: horizontal stripes coded as independent
    context-adaptive range-coder streams (template reads above a stripe's
    top are 0, models start fresh) by the native coder, stripes across host
    threads.  ctx_pre: an optional uint16 [rows, cols] context map
    (``compress.scab_ctx_map``), which must equal the coder's own scan."""
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    tmpl, n_stripes = scab_defaults(params, rows)
    body = native.scab_encode(img.astype(np.uint8), tmpl, n_stripes,
                              ramp=True, ctx_pre=ctx_pre)
    return _header(params, rows, cols, image_crc(img)) + body


def _decode_scab(body: bytes, rows: int, cols: int) -> np.ndarray:
    """A codec-13 payload: mode 2 (static-table rANS, the layout of
    ``compress._serialize_scab_rans``) or modes 0/1, by the native
    decoders (stripes across host threads); a payload they reject raises
    ValueError."""
    if len(body) >= 2 and body[1] == 2:
        return native.scab_rans_decode(body, rows, cols)
    return native.scab_decode(body, rows, cols)


def window_candidates(i0: int, j0: int, W: int, R: int,
                      cols: int) -> list[tuple[int, int]]:
    """Scan-ordered causal candidates (y, x) of tile (i0, j0): grid 1 (rows
    i0..max(i0-W, 0), for j0 >= W) then grid 2 (rows i0-W..max(i0-R, 0)),
    each row from its right end (compress8_test.cpp:137-143)."""
    out = []
    mini, minj = max(i0 - R, 0), max(j0 - R, 0)
    maxj = min(j0 + R, cols - W)
    if j0 >= W:
        for y in range(i0, max(i0 - W, 0) - 1, -1):
            for x in range(j0 - W, minj - 1, -1):
                out.append((y, x))
    for y in range(i0 - W, mini - 1, -1):
        for x in range(maxj, minj - 1, -1):
            out.append((y, x))
    return out


# ---------------------------------------------------------------------------
# codec 1: the full-prior-area tile codec (JAX codec.py:92-178, :322-406)
# ---------------------------------------------------------------------------

def c1_candidate_count(i0: int, j0: int, W: int, cols: int) -> int:
    """Candidates of tile (i0, j0) in the decodable codec-1 geometry
    (compress_test.cpp:81-111 with columns bounded to [0, cols-W],
    DEVIATIONS.md 5): phase A, every row strictly above the tile band x
    every in-bounds column; phase B, rows (i0-W, i0] x columns [0, j0-W]
    (empty for j0 < W)."""
    wa = max(cols - W + 1, 0)
    na = max(i0 - W + 1, 0)
    wb = (j0 - W + 1) if j0 >= W else 0
    nb = i0 - max(i0 - W + 1, 0) + 1      # rows [max(i0-W+1, 0), i0]
    return na * wa + nb * wb


def _c1_rank_to_pos(rank: int, i0: int, j0: int, W: int,
                    cols: int) -> tuple[int, int]:
    """(y, x) of a codec-1 rank: the inverse of the ascending enumeration
    in closed form (the decoder builds no candidate list)."""
    wa = max(cols - W + 1, 0)
    na = max(i0 - W + 1, 0)
    if rank < na * wa:
        return rank // wa, rank % wa
    r2 = rank - na * wa
    wb = j0 - W + 1
    y0 = max(i0 - W + 1, 0)
    return y0 + r2 // wb, r2 % wb


def _c1_sums(orig: np.ndarray, W: int) -> np.ndarray:
    """S, every W x W window's pixel sum, the per-page table of the codec-1
    search (JAX ``_c1_tables``), so that d = wP + S - 2 * corr; an int64
    integral image, as a float32 cumsum loses exactness past 2^24 set
    pixels."""
    g = orig.astype(np.int64)
    ii = np.zeros((g.shape[0] + 1, g.shape[1] + 1), np.int64)
    np.cumsum(np.cumsum(g, axis=0), axis=1, out=ii[1:, 1:])
    return (ii[W:, W:] - ii[:-W, W:] - ii[W:, :-W]
            + ii[:-W, :-W]).astype(np.int32)


def _c1_corr(orig: np.ndarray, Pv: np.ndarray, y0: int, y1: int,
             x1: int, W: int) -> np.ndarray:
    """corr[y, x] = <window(y, x), P> for y in [y0, y1), x in [0, x1): a
    matrix-vector product over row chunks of ~64 MB of float32 im2col."""
    out = np.empty((y1 - y0, x1), np.int32)
    step = max(1, (64 << 20) // max(1, x1 * W * W * 4))
    for ys in range(y0, y1, step):
        ye = min(ys + step, y1)
        sw = sliding_window_view(orig[ys:ye + W - 1], (W, W))[:, :x1]
        blk = np.ascontiguousarray(sw, dtype=np.float32)
        out[ys - y0:ye - y0] = (
            blk.reshape(ye - ys, x1, W * W) @ Pv).astype(np.int32)
    return out


def _search_c1(orig, S, P, i0, j0, W, cols, M):
    """The first strict minimum over the codec-1 enumeration, with the
    reference's d == 0 early exit.  Returns (rank, d) or (None, M + 1)."""
    Pv = P.astype(np.float32).ravel()
    wP = int(P.sum())
    wa = max(cols - W + 1, 0)
    na = max(i0 - W + 1, 0)
    parts = []
    if na > 0 and wa > 0:
        C = _c1_corr(orig, Pv, 0, na, wa, W)
        parts.append((wP + S[:na, :wa] - 2 * C).ravel())
    if j0 >= W:
        y0 = max(i0 - W + 1, 0)
        C = _c1_corr(orig, Pv, y0, i0 + 1, j0 - W + 1, W)
        parts.append((wP + S[y0:i0 + 1, :j0 - W + 1] - 2 * C).ravel())
    if not parts:
        return None, M + 1
    dp = np.concatenate(parts)
    stop = np.flatnonzero(np.minimum.accumulate(dp) <= 0)
    r = int(stop[0]) if stop.size else int(np.argmin(dp))
    return r, int(dp[r])


def _gcost(g: GolombCoder, u: int) -> int:
    """Bits of u under the adaptive Golomb context g."""
    return g.k + (u >> g.k) + 1


def _encode_c1(img, params) -> bytes:
    """Codec 1 (causal): per tile in raster order, the full-prior-area
    search, then the cheaper of the match and no-match records (JAX
    ``_encode_windowed`` :322-406 with codec 1: no pred or inv bit)."""
    W = params.W
    rows, cols = img.shape
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    orig = np.zeros((ny * W, nx * W), dtype=np.uint8)
    orig[:rows, :cols] = img
    S = _c1_sums(orig, W)
    w = BitWriter()
    hdr = _header(params, rows, cols, image_crc(img))
    w.write_bits(int.from_bytes(hdr, "big"), len(hdr) * 8)
    gm, gn = GolombCoder(), GolombCoder()
    for ti in range(ny):
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            P = orig[i0:i0 + W, j0:j0 + W]
            rank, _ = _search_c1(orig, S, P, i0, j0, W, cols, M)
            n_cands = c1_candidate_count(i0, j0, W, cols)
            idx_len = max(1, (n_cands - 1).bit_length()) if n_cands else 0
            wn = int(P.sum())
            ncost = 1 + _gcost(gn, wn) + enum_nbits(M, wn)
            use_match = False
            if rank is not None:
                y, x = _c1_rank_to_pos(rank, i0, j0, W, cols)
                P3 = P ^ orig[y:y + W, x:x + W]
                wm = int(P3.sum())
                # a tie goes to the match, the first option (JAX :383)
                use_match = (1 + idx_len + _gcost(gm, wm)
                             + enum_nbits(M, wm)) <= ncost
            if use_match:
                w.write_bits(1, 1)
                w.write_bits(rank, idx_len)
                golomb_encode(w, wm, gm.k)
                gm.code_sample(wm)
                enum_encode(w, P3.astype(bool))
            else:
                w.write_bits(0, 1)
                golomb_encode(w, wn, gn.k)
                gn.code_sample(wn)
                enum_encode(w, P.astype(bool))
    return w.getvalue()


# ---------------------------------------------------------------------------
# codecs 2 and 3: the dictionary codecs (JAX codec.py:515-628)
# ---------------------------------------------------------------------------

def _encode_dict(img, params) -> bytes:
    """compress2/3 made decodable: a dictionary of the origins of earlier
    tiles (the reference stores loop indices and reads patches there,
    compress2_test.cpp:108; the decodable codec stores origins).  The
    decoder replays the dictionary's growth, so a record is (match, index,
    weight, residual).  Codec 2 adds every no-match tile, codec 3 every
    tile farther than T from all entries."""
    W = params.W
    T = params.resolved_T()
    add_rule_threshold = params.codec == 3
    rows, cols = img.shape
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    grid = np.zeros((ny * W, nx * W), dtype=np.uint8)
    grid[:rows, :cols] = img
    w = BitWriter()
    hdr = _header(params, rows, cols, image_crc(img))
    w.write_bits(int.from_bytes(hdr, "big"), len(hdr) * 8)
    gm, gn = GolombCoder(), GolombCoder()
    dictionary: list[tuple[int, int]] = []
    # tiles as flat rows and the dictionary as a growing bank of them: one
    # XOR-popcount over the bank per tile, the first strict minimum wins
    tiles_flat = grid.reshape(ny, W, nx, W).swapaxes(1, 2).reshape(
        ny * nx, M)
    dict_rows = np.zeros((ny * nx, M), dtype=np.uint8)
    li = 0
    for ti in range(ny):
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            P = grid[i0:i0 + W, j0:j0 + W]
            Pf = tiles_flat[li]
            nd = len(dictionary)
            if nd:
                ds = (dict_rows[:nd] ^ Pf[None, :]).sum(axis=1,
                                                        dtype=np.int32)
                bestk = int(np.argmin(ds))
                bestd = int(ds[bestk])
            else:
                bestk, bestd = 0, M + 1
            wP = int(P.sum())
            idx_len = max(1, (nd - 1).bit_length()) if nd else 0
            use_match = False
            if nd:
                mcost = 1 + idx_len + _gcost(gm, bestd) + enum_nbits(M, bestd)
                ncost = 1 + _gcost(gn, wP) + enum_nbits(M, wP)
                use_match = mcost < ncost
            if use_match:
                w.write_bits(1, 1)
                w.write_bits(bestk, idx_len)
                golomb_encode(w, bestd, gm.k)
                gm.code_sample(bestd)
                ci, cj = dictionary[bestk]
                enum_encode(w, (P ^ grid[ci:ci + W, cj:cj + W]).astype(bool))
            else:
                w.write_bits(0, 1)
                golomb_encode(w, wP, gn.k)
                gn.code_sample(wP)
                enum_encode(w, P.astype(bool))
            if (add_rule_threshold and bestd > T) or \
                    (not add_rule_threshold and not use_match):
                dict_rows[nd] = Pf
                dictionary.append((i0, j0))
            li += 1
    return w.getvalue()


def _decode_dict(r: BitReader, codec, W, rows, cols, T) -> np.ndarray:
    """Inverse of ``_encode_dict``: the records, with the dictionary's
    growth replayed."""
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    grid = np.zeros((ny * W, nx * W), dtype=np.uint8)
    gm, gn = GolombCoder(), GolombCoder()
    dictionary: list[tuple[int, int]] = []
    dict_rows = np.zeros((ny * nx, M), dtype=np.uint8)
    add_rule_threshold = codec == 3
    for ti in range(ny):
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            match = r.read_bits(1)
            nd = len(dictionary)
            idx_len = max(1, (nd - 1).bit_length()) if nd else 0
            if match:
                k = r.read_bits(idx_len)
                if k >= nd:
                    raise ValueError(f"corrupt stream: dictionary index {k} "
                                     f">= {nd}")
                wt = golomb_decode(r, gm.k)
                gm.code_sample(wt)
                res = enum_decode(r, M, wt).reshape(W, W).astype(np.uint8)
                ci, cj = dictionary[k]
                P = res ^ grid[ci:ci + W, cj:cj + W]
            else:
                wt = golomb_decode(r, gn.k)
                gn.code_sample(wt)
                P = enum_decode(r, M, wt).reshape(W, W).astype(np.uint8)
            grid[i0:i0 + W, j0:j0 + W] = P
            if add_rule_threshold:
                if nd:
                    ds = (dict_rows[:nd] ^ P.reshape(M)[None, :]).sum(
                        axis=1, dtype=np.int32)
                    bestd = int(ds.min())
                else:
                    bestd = M + 1
                if bestd > T:
                    dict_rows[nd] = P.reshape(M)
                    dictionary.append((i0, j0))
            elif not match:
                dict_rows[nd] = P.reshape(M)
                dictionary.append((i0, j0))
    return grid[:rows, :cols].astype(bool)


def _encode_cabic(img, params) -> bytes:
    """Codec 12: 10-bit causal-template context-adaptive binary arithmetic
    coding of the whole page by the native coder (JAX codec.py:953)."""
    rows, cols = img.shape
    return (_header(params, rows, cols, image_crc(img))
            + native.cabic_encode(img.astype(np.uint8)))


def _med(P: np.ndarray) -> np.ndarray:
    """MED residual of a 0/1 page (JAX codec.py:179): each pixel XOR its up,
    left and up-left neighbours, order-1 on the first row and column, and
    r(0, 0) = P(0, 0) (DEVIATIONS.md 1)."""
    r = np.zeros_like(P)
    r[0, 1:] = P[0, 1:] ^ P[0, :-1]
    r[1:, 0] = P[1:, 0] ^ P[:-1, 0]
    r[1:, 1:] = P[1:, 1:] ^ P[:-1, 1:] ^ P[1:, :-1] ^ P[:-1, :-1]
    r[0, 0] = P[0, 0]
    return r


def _unmed(r: np.ndarray) -> np.ndarray:
    """Inverse of the MED residual: XOR prefix along rows, then columns."""
    x = np.bitwise_xor.accumulate(r, axis=1)
    return np.bitwise_xor.accumulate(x, axis=0)


def _medrle_runs(img: np.ndarray, residual: np.ndarray | None = None
                 ) -> np.ndarray:
    """Zero-run lengths of the MED residual in raster order, with the
    trailing run when it is not empty: codec 10's symbols."""
    if residual is None:
        residual = _med(np.asarray(img, dtype=np.uint8))
    flat = residual.ravel()
    ones = np.flatnonzero(flat)
    gaps = np.diff(np.concatenate([[-1], ones])) - 1
    trailing = flat.size - (int(ones[-1]) + 1) if ones.size else flat.size
    if trailing > 0:  # the decoder stops on the pixel count
        gaps = np.concatenate([gaps, [trailing]])
    return gaps.astype(np.int64)


def _encode_medrle(img: np.ndarray,
                   residual: np.ndarray | None = None) -> bytes:
    """Codec 10: MED residual (numpy, or computed on the device and passed
    in by ``compress.encode_planes_device``), its runs coded by the native
    adaptive exp-Golomb coder."""
    rows, cols = img.shape
    params = CodecParams(codec=MEDRLE_CODEC, W=0, T=0, R=0)
    hdr = _header(params, rows, cols, image_crc(img))
    return hdr + native.eg_encode_runs(_medrle_runs(img, residual))


def _decode_medrle_payload(payload: bytes, rows: int, cols: int
                           ) -> np.ndarray:
    """A codec-10 payload: the native EG decoder, then the inverse MED."""
    flat = native.eg_decode_runs(payload, rows * cols)
    return _unmed(flat.reshape(rows, cols).astype(bool))


def _decode_windowed(r: BitReader, codec, W, rows, cols, R,
                     strict) -> np.ndarray:
    """numpy decoder of a codec 1/4/6/7/8 payload, tile by tile in raster
    order (JAX codec.py:459-508)."""
    invert = codec == 8
    use_pred = codec in (7, 8)
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    work = np.zeros((ny * W, nx * W), dtype=np.uint8)   # encoder's state
    out = np.zeros((ny * W, nx * W), dtype=np.uint8)    # original pixels
    ref_img = work if strict else out
    gm, gn = GolombCoder(), GolombCoder()
    for ti in range(ny):
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            match = r.read_bits(1)
            pred = r.read_bits(1) if use_pred else 0
            if match:
                inv = r.read_bits(1) if invert else 0
                if codec == 1:
                    n_cands = c1_candidate_count(i0, j0, W, cols)
                else:
                    cands = window_candidates(i0, j0, W, R, cols)
                    n_cands = len(cands)
                idx_len = max(1, (n_cands - 1).bit_length()) if n_cands else 0
                rank = r.read_bits(idx_len)
                if rank >= n_cands:
                    raise ValueError("corrupt stream: candidate rank "
                                     f"{rank} >= {n_cands}")
                wt = golomb_decode(r, gm.k)
                gm.code_sample(wt)
            else:
                inv = 0
                wt = golomb_decode(r, gn.k)
                gn.code_sample(wt)
            res = enum_decode(r, M, wt).reshape(W, W).astype(np.uint8)
            if match:
                y, x = (_c1_rank_to_pos(rank, i0, j0, W, cols)
                        if codec == 1 else cands[rank])
                P2 = ref_img[y:y + W, x:x + W]
                P3 = _unmed(res) if pred else res
                Pm = P3 ^ P2
                P = (1 - Pm) if inv else Pm
            else:
                P = _unmed(res) if pred else res
            out[i0:i0 + W, j0:j0 + W] = P
            if strict:
                work[i0:i0 + W, j0:j0 + W] = res
    return out[:rows, :cols].astype(bool)


def _check_header(codec: int, W: int, rows: int, cols: int) -> None:
    """Validate header fields, which come from an untrusted stream, before
    any decoder sizes a buffer from them or divides by W (JAX
    codec.py:419-433: codecs 10, 12 and 13 have no tiles, so their W is not
    bounded)."""
    if codec not in VALID_CODECS:
        raise ValueError(f"corrupt BIC1 header: unknown codec id {codec}")
    if rows == 0 or cols == 0 or rows * cols > MAX_PIXELS:
        raise ValueError(f"implausible dimensions {rows}x{cols}")
    if codec in TILED_CODECS and not 1 <= W <= 64:
        raise ValueError(f"corrupt BIC1 header: W={W} out of range [1, 64] "
                         f"for codec {codec}")


def decode(blob: bytes, *, verify_crc: bool = True) -> np.ndarray:
    """Decode a BIC1 stream of any codec of ``VALID_CODECS`` to bool
    [rows, cols]."""
    if blob[:4] != MAGIC or len(blob) < HEADER_LEN:
        raise ValueError("not a BIC1 stream")
    crc, codec, flags, W, rows, cols, T, R = struct.unpack(
        "<IBBHIIII", blob[4:HEADER_LEN])
    _check_header(codec, W, rows, cols)
    r = BitReader(blob, bit_offset=HEADER_LEN * 8)
    if codec == SCAB_CODEC:
        out = _decode_scab(blob[HEADER_LEN:], rows, cols)
    elif codec == CABIC_CODEC:
        out = native.cabic_decode(blob[HEADER_LEN:], rows, cols)
    elif codec == MEDRLE_CODEC:
        out = _decode_medrle_payload(blob[HEADER_LEN:], rows, cols)
    elif codec == BSVD_CODEC:
        out = _decode_bsvd(r, W, rows, cols)
    elif codec in DICT_CODECS:
        out = _decode_dict(r, codec, W, rows, cols, T)
    elif codec == 1 or rows * cols > NATIVE_MAX_PIXELS:
        out = _decode_windowed(r, codec, W, rows, cols, R,
                               strict=bool(flags & 1))
    else:
        out = native.decode_windowed(blob, rows, cols)
    if verify_crc and image_crc(out) != crc:
        raise ValueError("BIC1 integrity check failed (corrupt stream)")
    return out


# ---------------------------------------------------------------------------
# grayscale (BICG) and color (BICC) containers
# ---------------------------------------------------------------------------

PGM_MAGIC = b"BICG"
PPM_MAGIC = b"BICC"
PGM_BACKENDS = ("host", "device", "device-assembly", "device-rans")


def encode_pgm(gray: np.ndarray, maxval: int,
               params: CodecParams | None = None, *,
               gray_code: bool = True, backend: str = "host",
               device="cuda") -> bytes:
    """Grayscale codec: the bitplanes (``bitplanes.decompose``), one BIC1
    stream each, in a BICG container.

    gray_code=True codes g = v ^ (v >> 1), whose planes are smoother.
    backend (module docstring): "host" codes each plane with `params`, or,
    params None, with the smaller of codec 13 and codec 10; "device" and
    "device-assembly" code the stack with codec 10 on `device` (params None
    or codec 10; other codecs take the host); "device-rans" codes it with
    codec 13 mode 2 on `device` (params of codec 13, else the defaults).

    Layout: "BICG" | u8 n_planes | u8 gray_code | u16 maxval |
    u32 len[n_planes] | the planes' BIC1 streams, LSB plane first."""
    from ..utils import bitplanes
    if backend not in PGM_BACKENDS:
        raise ValueError(f"backend={backend!r}: one of {PGM_BACKENDS}")
    gray = np.asarray(gray, dtype=np.uint32)
    if gray_code:
        gray = gray ^ (gray >> 1)
    planes = bitplanes.decompose(gray, maxval)
    if backend == "device-rans":
        from . import compress
        blobs = compress.encode_planes_rans(
            planes, params if params is not None
            and params.codec == SCAB_CODEC else None, device=device)
    elif backend in ("device", "device-assembly") and (
            params is None or params.codec == MEDRLE_CODEC):
        from . import compress
        blobs = compress.encode_planes_device(
            planes, "device" if backend == "device-assembly" else "native",
            device=device)
    elif params is None:
        # per plane, the smaller of the arithmetic and the run-length codec
        cand = [CodecParams(codec=SCAB_CODEC, W=0, T=0, R=0),
                CodecParams(codec=MEDRLE_CODEC, W=0)]
        blobs = [min((encode(p, c) for c in cand), key=len) for p in planes]
    else:
        blobs = [encode(p, params, device=device) for p in planes]
    out = bytearray(PGM_MAGIC)
    out += struct.pack("<BBH", len(blobs), 1 if gray_code else 0, maxval)
    for b in blobs:
        out += struct.pack("<I", len(b))
    for b in blobs:
        out += b
    return bytes(out)


def decode_pgm(blob: bytes) -> tuple[np.ndarray, int]:
    """A BICG stream -> (uint32 gray [rows, cols], maxval); the planes are
    decoded across host threads (the native decoders drop the GIL)."""
    from ..utils import bitplanes
    if blob[:4] != PGM_MAGIC:
        raise ValueError("not a BICG stream")
    nplanes, gflag, maxval = struct.unpack("<BBH", blob[4:8])
    lens = struct.unpack(f"<{nplanes}I", blob[8:8 + 4 * nplanes])
    off = 8 + 4 * nplanes
    spans = []
    for ln in lens:
        spans.append(blob[off:off + ln])
        off += ln
    workers = min(len(spans), os.cpu_count() or 1)
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            planes = list(ex.map(decode, spans))
    else:
        planes = [decode(s) for s in spans]
    gray = bitplanes.recompose(np.stack(planes))
    if gflag:
        # inverse gray code: v = g ^ (g >> 1) ^ (g >> 2) ^ ...
        v = gray.copy()
        for shift in range(1, 32):
            v ^= gray >> shift
        gray = v
    return gray, maxval


def encode_ppm(rgb_packed: np.ndarray, maxval: int,
               params: CodecParams | None = None, *,
               backend: str = "host", device="cuda") -> bytes:
    """Color codec: 0xRRGGBB-packed uint32 [rows, cols] (the reference's
    pixel_t, pnm.cpp:214) -> a BICG stream per channel.

    Layout: "BICC" | u16 maxval | u32 len[3] | the R, G, B BICG streams."""
    img = np.asarray(rgb_packed, dtype=np.uint32)
    chans = [(img >> 16) & 0xFF, (img >> 8) & 0xFF, img & 0xFF]
    blobs = [encode_pgm(c, maxval, params, backend=backend, device=device)
             for c in chans]
    out = bytearray(PPM_MAGIC)
    out += struct.pack("<H", maxval)
    for b in blobs:
        out += struct.pack("<I", len(b))
    for b in blobs:
        out += b
    return bytes(out)


def decode_ppm(blob: bytes) -> tuple[np.ndarray, int]:
    """A BICC stream -> (0xRRGGBB-packed uint32 [rows, cols], maxval)."""
    if blob[:4] != PPM_MAGIC:
        raise ValueError("not a BICC stream")
    (maxval,) = struct.unpack("<H", blob[4:6])
    lens = struct.unpack("<3I", blob[6:18])
    off = 18
    chans = []
    for ln in lens:
        chans.append(decode_pgm(blob[off:off + ln])[0])
        off += ln
    r, g, b = chans
    return (r.astype(np.uint32) << 16) | (g.astype(np.uint32) << 8) \
        | b.astype(np.uint32), maxval
