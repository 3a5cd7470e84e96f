"""The windowed device encoders: device analysis + native record packing.

Counterpart of ``binary_image_compression_tpu/models/compress.py``:
``encode_analyze`` (:70, fused and banded variants),
``_finish_selection`` (:186), ``_finish_selection_fields`` (:232),
``encode_analyze_decided`` (:278), ``_split_decided`` / ``_pack_decided``
(:322-356), ``_decide_modes`` (:359), ``encode`` (:397, codecs 4/7/8 with
its ``profile``; ``_assemble`` :448 is its call of native
``bic_decide_pack``), ``encode_batch`` (:483, codec 8) and
``encode_strict`` (:1049).

Causal mode, per batch of same-sized pages, on the device:
  1. packed int32 pages in, unpacked to 0/1;
  2. the search and serial-scan selection: kernel K1 (ops/fused_search) on
     the W-bit row-field plane, or, for shapes K1 does not take (W > 32, a
     band over its budget), kernel K4 (ops/select_windows) on a 64-bit
     plane;
  3. the finish: candidate gathers, inversion, MED, weights, residual words;
  4. kernel K2 (ops/decide): the mode decision;
  5. the chosen residual plus a packed header word, one int32 [B, T, 2+nw]
     block.
Strict mode, one page: kernel K3 (ops/strict) runs the whole residual-
substitution chain and yields the same record block.  Then ``pack_pages``
writes the streams: where the block lies on a CUDA device and M = W*W <=
256, kernel K9 (ops/recpack) packs every page's records on the device and
the host fetches the payloads; else per page on the host, native
``bic_pack_tiles``.  Codecs 4 and 7 (causal,
``encode``) take steps 1-3 with the complement trick off, the analysis dict
is fetched in one copy, and native ``bic_decide_pack`` decides the modes
and packs the records on the host, as in JAX (K2 is not on their path).
Streams are byte-identical to the JAX package's and the host encoder's.

Codec 13 (``encode_scab``, JAX :612): the page is uploaded packed and
unpacked on the device, where ``scab_ctx_map`` (:592) gives every pixel's
context id.  Host entropy (payload mode 1): the map is fetched once and the
native range coder codes it.  Device entropy (mode 2, ``scab_rans_page``
:649): the context counts, the static table, kernel K7's interleaved-rANS
streams (ops/ransdevice) and the table section are built on the device;
the host fetches them and concatenates bytes (``_serialize_scab_rans``
:697).  Unlike the JAX package's device mode, the stripe count is
re-derived from the stripe height, so no stripe is empty (its rows=6, T=4
stream has an empty last stripe, which both decoders reject).

Bitplane stacks (grayscale, JAX :743-930): the planes are uploaded packed
and their MED residuals taken on the device (``med_planes``).  Codec 10
(``encode_planes_device``): the residuals are fetched and the native EG
coder codes their runs (assembly "native"), or kernel K8 (ops/egdevice)
codes the whole stack on the device in one launch (assembly "device").
Codec 13 mode 2 (``encode_planes_rans``): the context maps,
counts and tables of the whole stack, batched, and one K7 launch for every
stripe of every plane.
"""

from __future__ import annotations

import collections
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np
import torch

from .. import native
from ..ops import (bitpack, decide, egdevice, fused_search, predict,
                   ransdevice, recpack, search, select_windows, strict)
from ..ops._cuda import resolve_device
from ..ops.bitstream import (BitWriter, enum_encode, enum_nbits,
                             golomb_encode, words_to_bytes)
from ..ops.entropy import GolombCoder
from ..utils.profiling import PipelineProfile, count, span
from .codec import (MEDRLE_CODEC, SCAB_CODEC, WINDOWED_CODECS, CodecParams,
                    _check_W, _encode_medrle, _encode_scab, _encode_windowed,
                    _header, image_crc, scab_stripes)

# pages the native host encoder took: causal R < W, strict shapes outside
# strict.supported, strict archive pages (not a device launch)
host_route = collections.Counter()


def _check_causal(params, codecs):
    """The device paths take `codecs` in causal mode; the rest is
    ``codec.encode`` (codec 6 and the non-windowed codecs are host codecs,
    in both packages), ``encode_scab`` (codec 13) or ``encode_strict``."""
    if params.codec not in codecs:
        raise ValueError(
            f"codec {params.codec}: this device encoder takes codecs "
            f"{'/'.join(map(str, codecs))} in causal mode; codec 6 and the "
            "host codecs 1/2/3/10/11/12 are codec.encode, codec 13 "
            "encode_scab")
    if params.strict:
        raise ValueError("strict mode is encoded by compress.encode_strict "
                         "(codec 8) or codec.encode")


def _med_tiles(P: torch.Tensor) -> torch.Tensor:
    """MED residual on dense [..., W, W] tiles (invertible origin)."""
    F = torch.nn.functional
    up = F.pad(P, (0, 0, 1, 0))[..., :-1, :]
    left = F.pad(P, (1, 0))[..., :-1]
    upleft = F.pad(P, (1, 0, 1, 0))[..., :-1, :-1]
    return P ^ up ^ left ^ upleft


def _selection_coords(sel, oy, W, nx, row0=0):
    """(b, ysel, xsel, i0, j0) gather coordinates in frame rows, each
    [B, T]; the tile rows start at frame row row0."""
    B, T, _ = sel.shape
    i0, j0, _, _ = search.tile_origins(T // nx * W, nx * W, W, sel.device)
    i0 = i0 + row0
    ysel = oy[None] + sel[..., 1].to(torch.int64)
    xsel = sel[..., 7].to(torch.int64)
    b = torch.arange(B, device=sel.device)[:, None]
    return b, ysel, xsel, i0[None], j0[None]


def _finish_selection_fields(plane, sel, oy, *, W: int, nx: int,
                             row0: int = 0):
    """Field-domain finish (requires 32 % W == 0): the selected candidate and
    the tile are [B, T, W] gathers of row fields from K1's plane; inversion,
    MED, weights and the residual words are field arithmetic."""
    b, ysel, xsel, i0, j0 = _selection_coords(sel, oy, W, nx, row0)
    ar = torch.arange(W, device=sel.device)
    P2f = bitpack.from_i32(plane[b[..., None], ysel[..., None] + ar,
                                 xsel[..., None]])
    Pf = bitpack.from_i32(plane[b[..., None], i0[..., None] + ar,
                                j0[..., None]])
    wmask = (1 << W) - 1
    inv = sel[..., 2] != 0
    P3 = torch.where(inv[..., None], Pf ^ wmask, Pf) ^ P2f
    dP3 = bitpack.med_fields(P3, wmask)
    dPf = bitpack.med_fields(Pf, wmask)
    res4f = torch.stack([P3, dP3, Pf, dPf], dim=2)             # [B, T, 4, W]
    weights4 = bitpack.popcount(res4f).sum(dim=-1)
    fpw = 32 // W                                   # fields per packed word
    nw = bitpack.nwords(W * W)
    # zero fields up to whole words: W*W < 32 (W <= 4) still fills one word
    r = torch.nn.functional.pad(res4f, (0, nw * fpw - W))
    B, T = sel.shape[:2]
    r = r.reshape(B, T, 4, nw, fpw)
    shifts = torch.arange(fpw - 1, -1, -1, device=sel.device) * W
    return weights4, (r << shifts).sum(dim=-1)


def _finish_selection(img, sel, oy, *, W: int, nx: int, row0: int = 0):
    """Dense finish for 32 % W != 0: [B, T, W, W] pixel gathers; residuals
    packed with bitpack.pack."""
    b, ysel, xsel, i0, j0 = _selection_coords(sel, oy, W, nx, row0)
    ar = torch.arange(W, device=sel.device)

    def grab(y, x):
        return img[b[..., None, None], (y[..., None] + ar)[..., None],
                   (x[..., None] + ar)[..., None, :]].to(torch.int64)

    P2 = grab(ysel, xsel)
    P = grab(i0.expand_as(ysel), j0.expand_as(xsel))
    inv = sel[..., 2] != 0
    P3 = torch.where(inv[..., None, None], 1 - P, P) ^ P2
    res4 = torch.stack([P3, _med_tiles(P3), P, _med_tiles(P)], dim=2)
    weights4 = res4.sum(dim=(-1, -2))
    B, T = sel.shape[:2]
    return weights4, bitpack.pack(res4.reshape(B, T, 4, W * W))


def encode_analyze(img, *, W: int, R: int, T_thresh: int, rows: int,
                   cols: int, invert: bool = True) -> dict:
    """Device analysis for a batch of pages, before the mode decision.

    img: 0/1 [B, ny*W, nx*W] zero-padded tile grids.  Returns per-tile
    [B, T, ...] tensors: rank, n_cands, inv, has_cands, weights4 (match
    nonpred, match pred, nomatch nonpred, nomatch pred), idx_len and
    residual4 (int64 words [B, T, 4, nwords(W*W)])."""
    if R < W:
        raise ValueError(f"device search requires R >= W (got R={R}, "
                         f"W={W}); use the host encoder")
    ny, nx = -(-rows // W), -(-cols // W)
    if fused_search.fused_supported(ny, nx, W, R):
        sel, oy, plane = fused_search.fused_search_select(
            img, ny, nx, W=W, R=R, T_thresh=T_thresh, cols=cols,
            invert=invert)
        return finish_analysis(img, sel, oy, plane, W=W, nx=nx)
    # the banded route (compress.py:128-135 of the JAX package): K4 scores
    # the band from its own 64-bit plane and selects
    sel, oy, _ = select_windows.select_windows(
        img, ny, nx, W=W, R=R, T_thresh=T_thresh, cols=cols, invert=invert)
    return finish_analysis(img, sel, oy, None, W=W, nx=nx)


def finish_analysis(img, sel, oy, plane, *, W: int, nx: int,
                    row0: int = 0) -> dict:
    """The finish after the selection: the dict ``encode_analyze`` returns.
    The field finish reads K1's 32-bit plane; the banded route (plane
    None) takes the dense finish.  img, plane and oy are in frame rows,
    whose tile rows start at row0 (a shard's frame, parallel/tileshard)."""
    if plane is not None and 32 % W == 0:
        weights4, residual4 = _finish_selection_fields(plane, sel, oy, W=W,
                                                       nx=nx, row0=row0)
    else:
        weights4, residual4 = _finish_selection(img, sel, oy, W=W, nx=nx,
                                                row0=row0)
    n_cands = sel[..., 5]
    return dict(rank=sel[..., 4], n_cands=n_cands, inv=sel[..., 2] != 0,
                has_cands=sel[..., 6] != 0, weights4=weights4,
                idx_len=decide.idx_len(n_cands), residual4=residual4)


@lru_cache(maxsize=None)
def enb_lut(M: int) -> np.ndarray:
    """int32 [M+1]: enb[w] = ceil(log2 C(M, w)), the enumerative rank bits."""
    return np.array([native.enum_nbits(M, w) for w in range(M + 1)],
                    dtype=np.int32)


def encode_analyze_decided(img_packed, *, W: int, R: int, T_thresh: int,
                           rows: int, cols: int) -> torch.Tensor:
    """Fully decided codec-8 analysis: packed pages in, records out.

    img_packed: int32 [B, ny*W, nwords(nx*W)] (bitpack layout of the padded
    tile grids, uint32 bit patterns).  Returns int32 [B, T, 2 + nwords(M)]:
    column 0 packs (mode 2b | inv 1b | k_used 5b | idx_len 6b | weight 17b),
    column 1 is the rank, the rest are the chosen residual's words."""
    nx = -(-cols // W)
    img = bitpack.unpack(img_packed, nx * W)
    out = encode_analyze(img, W=W, R=R, T_thresh=T_thresh, rows=rows,
                         cols=cols, invert=True)
    return decide_records(out, W * W)


def decide_records(out: dict, M: int) -> torch.Tensor:
    """K2 on ``encode_analyze``'s output, then the chosen residual and the
    packed header word: the int32 [B, T, 2 + nw] record block."""
    i32 = lambda t: t.to(torch.int32).contiguous()
    enb = torch.from_numpy(enb_lut(M)).to(out["weights4"].device)
    mode, weight, k_used = decide.decide_modes(
        i32(out["weights4"]), i32(out["has_cands"]), i32(out["idx_len"]),
        enb, codec_id=8)
    res = torch.gather(out["residual4"], 2,
                       mode.to(torch.int64)[..., None, None].expand(
                           -1, -1, 1, out["residual4"].shape[-1]))[:, :, 0]
    return _record_block(mode, out["inv"], k_used, out["idx_len"], weight,
                         out["rank"], res)


def _record_block(mode, inv, k_used, idx_len, weight, rank, words):
    """The int32 [..., 2 + nw] record block of decided tiles: the header
    word, the rank and the chosen residual's words.  inv and idx_len are
    coded for matches only, so they are zeroed for the other modes."""
    mode = mode.to(torch.int64)
    is_match = mode < 2
    inv = (is_match & (inv != 0)).to(torch.int64)
    il = torch.where(is_match, idx_len.to(torch.int64), 0)
    w0 = (mode | (inv << 2) | (k_used.to(torch.int64) << 3) | (il << 8)
          | (weight.to(torch.int64) << 14))
    return torch.cat([w0[..., None].to(torch.int32),
                      rank[..., None].to(torch.int32),
                      bitpack.to_i32(words)], dim=-1)


def _split_decided(block: np.ndarray) -> dict:
    """Host view of one page's int32 [T, 2 + nw] record block."""
    w0 = block[:, 0]
    return dict(mode=w0 & 3, inv=((w0 >> 2) & 1).astype(bool),
                k_used=(w0 >> 3) & 31, idx_len=(w0 >> 8) & 63,
                weight=w0 >> 14, rank=block[:, 1],
                residual=np.ascontiguousarray(block[:, 2:]).view(np.uint32))


def _pack_decided(block: np.ndarray, hdr: bytes, M: int) -> bytes:
    """Encoder tail: one page's int32 [T, 2 + nw] record block split and
    unpacked on the host (span ``pack.unpack``), then native
    bic_pack_tiles (``pack.native``)."""
    with span("pack.unpack"):
        out = _split_decided(block)
        res_bits = bitpack.np_unpack(out["residual"], M).astype(np.uint8)
        rank = out["rank"].astype(np.int64)
    with span("pack.native"):
        return native.pack_tiles(hdr, M, out["mode"], out["inv"], rank,
                                 out["idx_len"], out["weight"], res_bits)


def pack_records_plain(out: dict, hdr: bytes, M: int) -> bytes:
    """Pure-Python twin of ``_pack_decided`` (the native packer's oracle)."""
    res_bits = bitpack.np_unpack(out["residual"], M)
    wtr = BitWriter()
    wtr.write_bits(int.from_bytes(hdr, "big"), len(hdr) * 8)
    for t in range(len(out["mode"])):
        m = int(out["mode"][t])
        if m < 2:
            wtr.write_bits(1, 1)
            wtr.write_bits(m & 1, 1)
            wtr.write_bits(int(out["inv"][t]), 1)
            wtr.write_bits(int(out["rank"][t]), int(out["idx_len"][t]))
        else:
            wtr.write_bits(0, 1)
            wtr.write_bits(m & 1, 1)
        golomb_encode(wtr, int(out["weight"][t]), int(out["k_used"][t]))
        enum_encode(wtr, res_bits[t])
    return wtr.getvalue()


def _decide_modes(out: dict, M: int, codec_id: int = 8):
    """Host replay of the mode decision with two GolombCoder contexts
    (K2's second oracle; the same integer math as the host encoder)."""
    use_pred, mcost, ncost = decide.mode_costs(codec_id)
    w4 = np.asarray(out["weights4"])
    hc = np.asarray(out["has_cands"])
    il = np.asarray(out["idx_len"])
    T = w4.shape[0]
    enb = np.array([enum_nbits(M, w) for w in range(M + 1)], dtype=np.int64)
    gm, gn = GolombCoder(), GolombCoder()
    mode = np.empty(T, dtype=np.int32)
    weight = np.empty(T, dtype=np.int32)
    k_used = np.empty(T, dtype=np.int32)
    gk = lambda g, u: g.k + (int(u) >> g.k) + 1
    big = decide.BIG
    for t in range(T):
        c = [
            mcost + il[t] + gk(gm, w4[t, 0]) + enb[w4[t, 0]]
            if hc[t] else big,
            mcost + il[t] + gk(gm, w4[t, 1]) + enb[w4[t, 1]]
            if (hc[t] and use_pred) else big,
            ncost + gk(gn, w4[t, 2]) + enb[w4[t, 2]],
            ncost + gk(gn, w4[t, 3]) + enb[w4[t, 3]] if use_pred else big,
        ]
        m = int(np.argmin(c))
        mode[t] = m
        weight[t] = w4[t, m]
        g = gm if m < 2 else gn
        k_used[t] = g.k
        g.code_sample(int(w4[t, m]))
    return mode, weight, k_used


def host_encode(img: np.ndarray, params: CodecParams) -> bytes:
    """The native host encoder, for the shapes the device paths leave to
    it: causal R < W (the device band covers grid-1 rows only for R >= W)
    and strict shapes outside ``strict.supported``.  It writes the windowed
    codecs 4/6/7/8 only: another codec id would head a windowed payload
    that no decoder reads."""
    if params.codec not in WINDOWED_CODECS:
        raise ValueError(f"codec {params.codec}: the native windowed "
                         f"encoder writes codecs 4/6/7/8 only")
    host_route["pages"] += 1
    return _encode_windowed(img, params)


def _upload(pages: np.ndarray, W: int, dev) -> torch.Tensor:
    """Zero-pad bool [B, rows, cols] to the tile grid, pack to uint32 words
    (span ``upload.host``) and upload them as int32 [B, ny*W,
    nwords(nx*W)] (``upload.h2d``, counter ``h2d_bytes``)."""
    B, rows, cols = pages.shape
    ny, nx = -(-rows // W), -(-cols // W)
    with span("upload.host"):
        grid = np.zeros((B, ny * W, nx * W), dtype=bool)
        grid[:, :rows, :cols] = pages
        packed = bitpack.np_pack(grid).view(np.int32)
    with span("upload.h2d"):
        words = torch.from_numpy(packed).to(dev)
        count("h2d_bytes", packed.nbytes)
    return words


def _fetch(block: torch.Tensor) -> np.ndarray:
    """A device result on the host (span ``fetch``, counter
    ``d2h_bytes``): the copy waits for the work queued before it."""
    with span("fetch"):
        out = block.cpu().numpy()
        count("d2h_bytes", out.nbytes)
    return out


def encode(img: np.ndarray, params: CodecParams | None = None, *,
           device="cuda", profile: PipelineProfile | None = None) -> bytes:
    """Encode one page with codec 4, 7 or 8 in causal mode: the analysis on
    `device`, the record packing on the host or, for codec 8 on a card at
    W <= 16, on the card (``pack_pages``).  Byte-identical to the host
    encoder.

    Codec 8 decides its modes on the device (K2) and hands the record
    block to ``pack_pages``; codecs 4 and 7 fetch the analysis dict
    (``fetch_analysis``) and decide and pack in native ``bic_decide_pack``
    (JAX ``_assemble`` :448).  R < W goes to the native host encoder.
    profile: a ``PipelineProfile`` that collects the stages ``grid_prep``
    (pad, pack, upload), ``device_analysis`` (codec 8: the analysis
    enqueued; codecs 4/7: up to and with the fetch) and ``native_pack``
    (codec 8: ``pack_pages``, whose fetch waits for the card; ``compress
    --profile``).  The page is one request of the recorder
    (``utils/profiling``, span ``page``), with the spans ``upload``,
    ``analysis``, ``fetch`` and ``pack`` under it."""
    prof = profile if profile is not None else PipelineProfile()
    params = params or CodecParams(codec=8, strict=False)
    _check_causal(params, (4, 7, 8))
    _check_W(params)
    with span("page"):
        img = np.asarray(img, dtype=bool)
        if params.R < params.W:
            return host_encode(img, params)
        dev = resolve_device(device)
        rows, cols = img.shape
        W, T_thresh = params.W, params.resolved_T()
        kw = dict(W=W, R=params.R, T_thresh=T_thresh, rows=rows, cols=cols)
        with prof.stage("grid_prep", rows * cols // 8), span("upload"):
            packed = _upload(img[None], W, dev)
        if params.codec == 8:
            with prof.stage("device_analysis"), span("analysis"):
                block = encode_analyze_decided(packed, **kw)
            with prof.stage("native_pack"):
                return pack_pages(block, img[None], params)[0]
        with prof.stage("device_analysis"):
            out = fetch_analysis(encode_analyze(
                bitpack.unpack(packed, -(-cols // W) * W), invert=False,
                **kw))
        with prof.stage("native_pack"):
            hdr = _header(params, rows, cols, image_crc(img))
            return native.decide_pack(
                hdr, W * W, params.codec, out["weights4"][0],
                out["has_cands"][0], out["idx_len"][0], out["inv"][0],
                out["rank"][0], out["residual4"][0])[0]


_ANALYSIS_FIELDS = ("rank", "n_cands", "inv", "has_cands", "idx_len")


def fetch_analysis(out: dict) -> dict:
    """``encode_analyze``'s dict on the host in one copy
    (``analysis_block``), split again into numpy arrays
    (``split_analysis``)."""
    return split_analysis(analysis_block(out).cpu().numpy())


def analysis_block(out: dict) -> torch.Tensor:
    """The per-tile fields, the four weights and the residual words of
    ``encode_analyze``'s dict side by side in one int64 [B, T, 9 + 4 * nw]
    tensor on the analysis's device."""
    B, T, _, nw = out["residual4"].shape
    return torch.cat([out[k].to(torch.int64)[..., None]
                      for k in _ANALYSIS_FIELDS]
                     + [out["weights4"].to(torch.int64),
                        out["residual4"].to(torch.int64).reshape(B, T, -1)],
                     dim=-1)


def split_analysis(block: np.ndarray) -> dict:
    """An ``analysis_block`` on the host -> the dict of numpy arrays
    (residual4 as uint32 [..., 4, nw])."""
    n = len(_ANALYSIS_FIELDS)
    nw = (block.shape[-1] - n - 4) // 4
    got = {k: block[..., i] for i, k in enumerate(_ANALYSIS_FIELDS)}
    got["inv"] = got["inv"] != 0
    got["has_cands"] = got["has_cands"] != 0
    got["weights4"] = block[..., n:n + 4]
    got["residual4"] = block[..., n + 4:].astype(np.uint32).reshape(
        block.shape[:-1] + (4, nw))
    return got


def encode_batch(pages: np.ndarray, params: CodecParams | None = None, *,
                 device="cuda") -> list[bytes]:
    """Encode same-sized pages bool [B, rows, cols] with codec 8: one K1 and
    one K2 launch for the whole batch, then ``pack_pages`` (on the card,
    one K9 launch for the batch; JAX's ``encode_batch`` takes codec 8 only
    too)."""
    params = params or CodecParams(codec=8, strict=False)
    _check_causal(params, (8,))
    _check_W(params)
    pages = np.asarray(pages, dtype=bool)
    if params.R < params.W:
        return [host_encode(p, params) for p in pages]
    dev = resolve_device(device)
    _, rows, cols = pages.shape
    with span("upload"):
        packed = _upload(pages, params.W, dev)
    with span("analysis"):
        block = encode_analyze_decided(
            packed, W=params.W, R=params.R, T_thresh=params.resolved_T(),
            rows=rows, cols=cols)
    return pack_pages(block, pages, params)


def pack_pages(block, pages: np.ndarray,
               params: CodecParams) -> list[bytes]:
    """Each page's stream from a decided [B, T, 2 + nw] record block: a
    tensor where the analysis left it, or an array on the host.

    The route follows the block.  On a CUDA device with M = W*W <=
    ``recpack.MAX_M`` (W <= 16), kernel K9 packs every page in one launch
    and the host fetches the bit counts and the payload words used
    (``_pack_device``).  Else the block is fetched (``_fetch``, a tensor)
    and native ``bic_pack_tiles`` packs one page per host thread
    (``_on_threads``; ``_pack_decided``).  Counters
    ``pack_pages_device`` / ``pack_pages_host``: the pages each route
    packs.  Spans: ``pack`` over the whole, and on the page's thread
    ``pack.page`` with its ``crc`` (header and ``image_crc``) and, on the
    host route, ``pack.unpack`` and ``pack.native``."""
    B, rows, cols = pages.shape
    M = params.W * params.W

    def header(b):
        with span("crc"):
            return _header(params, rows, cols, image_crc(pages[b]))

    def page_header(b):
        with span("pack.page", parent=pack):
            return header(b)

    def build(b):
        with span("pack.page", parent=pack):
            return _pack_decided(host[b], header(b), M)

    with span("pack") as pack:
        if (isinstance(block, torch.Tensor) and block.is_cuda
                and M <= recpack.MAX_M):
            count("pack_pages_device", B)
            return _pack_device(block, M, page_header)
        count("pack_pages_host", B)
        host = _fetch(block) if isinstance(block, torch.Tensor) else block
        return _on_threads(build, B)


def _on_threads(fn, B: int) -> list:
    """[fn(b) for b < B], on as many host threads as B and the CPUs this
    process may run on (``os.sched_getaffinity``) allow."""
    workers = min(B, len(os.sched_getaffinity(0)))
    if workers <= 1:
        return [fn(b) for b in range(B)]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, range(B)))


def _pack_device(block: torch.Tensor, M: int, header) -> list[bytes]:
    """The CUDA route of ``pack_pages``: K9 enqueued, the pages' headers
    and CRCs on host threads while the card works, then the bit counts and
    the payload words used fetched (``_fetch``: the first waits for the
    card), each page its header and payload bytes."""
    words, nbits = recpack.pack_records(block.contiguous(), M)
    hdrs = _on_threads(header, block.shape[0])
    bits = _fetch(nbits)
    if (bits < 0).any():
        raise ValueError(f"record block: a weight outside [0, {M}] on "
                         f"page(s) {np.flatnonzero(bits < 0).tolist()}")
    starts, sizes, used = recpack.page_layout(bits)
    payload = _fetch(words[:used]).view(np.uint8)
    return [h + payload[s:s + n].tobytes()
            for h, s, n in zip(hdrs, starts, sizes)]


def encode_strict(img: np.ndarray, params: CodecParams | None = None, *,
                  device="cuda") -> bytes:
    """Encode one page in strict mode (codec 8): kernel K3 on `device` for
    the shapes ``strict.supported`` takes, else the native host encoder.
    Byte-identical to the host strict encoder."""
    params = params or CodecParams(codec=8, strict=True)
    if params.codec != 8 or not params.strict:
        raise ValueError("encode_strict takes codec 8 with strict=True")
    _check_W(params)
    img = np.asarray(img, dtype=bool)
    W, R = params.W, params.R
    if not strict.supported(W, R):
        return host_encode(img, params)
    dev = resolve_device(device)
    rows, cols = img.shape
    grid = np.zeros((-(-rows // W) * W, -(-cols // W) * W), dtype=bool)
    grid[:rows, :cols] = img
    enb = torch.from_numpy(enb_lut(W * W)).to(dev)
    out, fields = strict.strict_analyze(
        torch.from_numpy(grid).to(dev), enb, W=W, R=R,
        T_thresh=params.resolved_T(), cols=cols)
    c = {n: out[:, i] for i, n in enumerate(strict.OUT_FIELDS)}
    block = _record_block(c["mode"], c["inv"], c["k_used"], c["idx_len"],
                          c["weight"], c["rank"],
                          bitpack.fields_to_words(fields, W))
    return pack_pages(block[None], img[None], params)[0]


# (dr, dc, bit) per template: bit `bit` of a pixel's context is the pixel at
# (r + dr, c + dc); the native coder's incremental scan (bic_native.cpp
# scan_stripe) lays the bits out the same way
_SCAB_TMPL = {
    10: [(-2, -1, 9), (-2, 0, 8), (-2, 1, 7), (-1, -2, 6), (-1, -1, 5),
         (-1, 0, 4), (-1, 1, 3), (-1, 2, 2), (0, -2, 1), (0, -1, 0)],
    12: [(-2, -1, 11), (-2, 0, 10), (-2, 1, 9), (-1, -2, 8), (-1, -1, 7),
         (-1, 0, 6), (-1, 1, 5), (-1, 2, 4), (-1, 3, 3), (0, -3, 2),
         (0, -2, 1), (0, -1, 0)],
}


def scab_ctx_map(bits: torch.Tensor, *, tmpl: int,
                 stripe_rows: int) -> torch.Tensor:
    """Codec-13 context ids of every pixel: int16 [..., rows, cols].

    bits: 0/1 [..., rows, cols], a page or a stack of them.  Template reads
    outside the page or above the pixel's stripe top are 0: each stripe gets
    two zero rows above it and the page three zero columns on each side, and
    every template bit is a shifted view of that."""
    rows, cols = bits.shape[-2:]
    lead = bits.shape[:-2]
    S = -(-rows // stripe_rows)
    F = torch.nn.functional
    g = F.pad(bits.to(torch.int16), (0, 0, 0, S * stripe_rows - rows))
    g = F.pad(g.reshape(lead + (S, stripe_rows, cols)), (3, 3, 2, 0))
    ctx = torch.zeros(lead + (S, stripe_rows, cols), dtype=torch.int16,
                      device=bits.device)
    for dr, dc, bit in _SCAB_TMPL[tmpl]:
        ctx |= g[..., 2 + dr:2 + dr + stripe_rows, 3 + dc:3 + dc + cols] << bit
    ctx = ctx.reshape(lead + (S * stripe_rows, cols))[..., :rows, :]
    return ctx.contiguous()       # K7 takes a stack's maps contiguous


def scab_upload(img: np.ndarray, dev) -> torch.Tensor:
    """The page uploaded as packed words and unpacked on `dev` (span
    ``upload``): bool [rows, cols]."""
    with span("upload"):
        return bitpack.unpack(_upload(img[None], 1, dev), img.shape[1])[0]


def encode_scab(img: np.ndarray, params: CodecParams | None = None, *,
                entropy: str = "host", device="cuda") -> bytes:
    """Encode one page with codec 13, its context map on `device`.

    entropy="host": the map is fetched and the native range coder codes it
    (payload mode 1), byte-identical to ``codec.encode``.  entropy="device":
    the whole mode-2 payload (static table and interleaved-rANS streams,
    kernel K7) is built on the device and the host concatenates bytes."""
    params = params or CodecParams(codec=SCAB_CODEC, W=0, T=0, R=0)
    if params.codec != SCAB_CODEC:
        raise ValueError(f"encode_scab takes codec 13, not {params.codec}")
    if entropy not in ("host", "device"):
        raise ValueError(f"entropy={entropy!r}: 'host' or 'device'")
    with span("page"):
        img = np.asarray(img, dtype=bool)
        tmpl, _, stripe_rows = scab_stripes(params, img.shape[0])
        if entropy == "device":
            return _encode_scab_device(img, params, tmpl, stripe_rows,
                                       device=device)
        bits = scab_upload(img, resolve_device(device))
        ctx = scab_ctx_map(bits, tmpl=tmpl, stripe_rows=stripe_rows)
        return _encode_scab(img, params,
                            ctx_pre=ctx.cpu().numpy().view(np.uint16))


def scab_rans_page(bits: torch.Tensor, *, tmpl: int, stripe_rows: int,
                   n_lanes: int = ransdevice.N_LANES_DEFAULT) -> dict:
    """Context map and the mode-2 payload's fields, on the device of
    `bits` (``ransdevice.rans_page_encode``).  Spans: ``rans_fields`` over
    the whole, ``rans.map`` over the map."""
    with span("rans_fields"):
        with span("rans.map"):
            ctx = scab_ctx_map(bits, tmpl=tmpl, stripe_rows=stripe_rows)
        return ransdevice.rans_page_encode(bits, ctx,
                                           stripe_rows=stripe_rows,
                                           n_lanes=n_lanes)


def fetch_rans_fields(out: dict) -> dict:
    """The mode-2 fields of one page on the host (``fetch_rans_stack``)."""
    return fetch_rans_stack({k: v[None] for k, v in out.items()})[0]


def fetch_rans_stack(out: dict) -> list[dict]:
    """The mode-2 fields of a stack of P pages on the host, in two copies:
    the small fields in one int64 vector, then the word streams cut to the
    longest one (span ``fetch``, counter ``d2h_bytes``).  Returns one dict
    of numpy fields per page."""
    P, S, N = out["states"].shape
    i64 = lambda t: t.reshape(-1).to(torch.int64)
    with span("fetch"):
        small = torch.cat([i64(out["transmit"]), i64(out["q_default"]),
                           bitpack.from_i32(out["states"]).reshape(-1),
                           i64(out["bits"]), i64(out["tab_words"]),
                           i64(out["tab_bits"]),
                           i64(out["n_transmit"])]).cpu().numpy()
        parts = np.split(small, np.cumsum(
            [P * ransdevice.PSCALE, P, P * S * N, P * S,
             P * ransdevice.TABLE_WORDS, P]))
        nbits = parts[3].reshape(P, S)
        nw_max = max(1, -(-int(nbits.max()) // 32))
        words = out["words"][..., :nw_max].cpu().numpy().view(np.uint32)
        count("d2h_bytes", small.nbytes + words.nbytes)
    transmit = parts[0].astype(bool).reshape(P, -1)
    states = parts[2].reshape(P, S, N)
    tab_words = parts[4].reshape(P, -1)
    return [dict(transmit=transmit[i], q_default=int(parts[1][i]),
                 states=states[i], bits=nbits[i], tab_words=tab_words[i],
                 tab_bits=int(parts[5][i]), n_transmit=int(parts[6][i]),
                 words=words[i]) for i in range(P)]


def _encode_scab_device(img, params, tmpl, stripe_rows,
                        n_lanes: int | None = None, *, device="cuda") -> bytes:
    """The mode-2 stream: the page uploaded to `device`, the payload's
    fields built there (``scab_rans_page``), fetched, and serialized on the
    host."""
    rows, cols = img.shape
    n_lanes = n_lanes or ransdevice.N_LANES_DEFAULT
    bits = scab_upload(img, resolve_device(device))
    f = fetch_rans_fields(scab_rans_page(bits, tmpl=tmpl,
                                         stripe_rows=stripe_rows,
                                         n_lanes=n_lanes))
    body = _serialize_scab_rans(f, tmpl, -(-rows // stripe_rows),
                                stripe_rows, n_lanes)
    with span("crc"):
        head = _header(params, rows, cols, image_crc(img))
    return head + body


def _serialize_scab_rans(f: dict, tmpl, n_stripes, stripe_rows,
                         n_lanes) -> bytes:
    """The mode-2 body from the fetched fields (after the BIC1 header;
    span ``serialize``):

      u8 tmpl | u8 mode=2 | u16 n_stripes | i32 stripe_rows
      u8 n_lanes | u8 q_default | u16 n_transmit
      u8 bitmap_mode (0 raw / 1 Rice gaps) | u8 rice_k | u16 bitmap_bytes
      bitmap: the raw 512 B mask, or Rice(k) codes of the gaps between
        transmitted context ids (g0 = id0, gi = id_i - id_{i-1} - 1)
      ceil(n_transmit * 6 / 8) B probability codes (MSB-first)
      u32 stripe_byte_len[n_stripes]
      per stripe: n_lanes x u32 LE initial decoder states, then the u16
        big-endian rANS word stream
    """
    with span("serialize"):
        ids = np.flatnonzero(np.asarray(f["transmit"], bool))
        gaps = np.diff(np.concatenate([[-1], ids])) - 1
        # Rice bits of the gaps for each k; the first smallest wins
        nbits = [(k + 1) * gaps.size + int((gaps >> k).sum())
                 for k in range(13)]
        best_k = int(np.argmin(nbits))
        if ids.size and -(-nbits[best_k] // 8) < 512:
            bm_mode, rice_k = 1, best_k
            bw = BitWriter()
            for g in gaps:
                golomb_encode(bw, int(g), rice_k)
            bm_bytes = bw.getvalue()
        else:
            bm_mode, rice_k = 0, 0
            bm_bytes = np.packbits(np.asarray(f["transmit"],
                                              bool)).tobytes()
        body = bytearray()
        body += struct.pack("<BBHi", tmpl, 2, n_stripes, stripe_rows)
        body += struct.pack("<BBH", n_lanes, int(f["q_default"]),
                            int(f["n_transmit"]))
        body += struct.pack("<BBH", bm_mode, rice_k, len(bm_bytes))
        body += bm_bytes
        body += words_to_bytes(f["tab_words"], int(f["tab_bits"]))
        streams = [np.asarray(f["states"][s], "<u4").tobytes()
                   + words_to_bytes(f["words"][s], int(f["bits"][s]))
                   for s in range(n_stripes)]
        for sb in streams:
            body += struct.pack("<I", len(sb))
        for sb in streams:
            body += sb
        return bytes(body)


# ---------------------------------------------------------------------------
# bitplane stacks (grayscale; JAX compress.py:743-930)
# ---------------------------------------------------------------------------

def upload_planes(planes: np.ndarray, dev) -> torch.Tensor:
    """bool [P, rows, cols] packed on the host and uploaded as int32
    [P, rows, nwords(cols)]."""
    return _upload(np.asarray(planes, dtype=bool), 1, dev)


def med_planes(packed: torch.Tensor, cols: int) -> torch.Tensor:
    """MED residuals of a packed plane stack int32 [P, rows, nw], on its
    device (JAX ``med_planes`` :792, which packs first)."""
    return predict.med_forward(packed, cols)


def encode_planes_device(planes: np.ndarray, assembly: str = "device", *,
                         device="cuda") -> list[bytes]:
    """Codec-10 streams of a bitplane stack, each equal to
    ``codec.encode(plane, CodecParams(codec=10))`` (JAX :864).

    The stack is uploaded packed and its MED residuals taken on `device`.
    assembly="native": the residuals are fetched and the native EG coder
    codes their runs.  assembly="device": kernel K8 codes every plane of
    the stack in one launch (``egdevice.eg_encode``; its plain version on
    the CPU), the words are fetched and the host adds the headers.  JAX
    sends planes past its run-array ladder to the native coder; K8 reads
    the packed residual and has no run array, so every plane stays on
    `device`."""
    if assembly not in ("device", "native"):
        raise ValueError(f"assembly={assembly!r}: 'device' or 'native'")
    planes = np.asarray(planes, dtype=bool)
    P, rows, cols = planes.shape
    res = med_planes(upload_planes(planes, resolve_device(device)), cols)
    if assembly == "native":
        return _encode_planes_native(planes, res, cols)
    words, nbits = egdevice.eg_encode(res, cols)
    nbits = nbits.cpu().numpy()
    tw = egdevice.payload_words(rows * cols)
    if int(nbits.max()) > tw * 32:
        raise RuntimeError(f"codec 10: a payload of {int(nbits.max())} bits "
                           f"is past its buffer of {tw} words")
    nw = max(1, -(-int(nbits.max()) // 32))
    words = words[:, :nw].cpu().numpy().view(np.uint32)
    params = CodecParams(codec=MEDRLE_CODEC, W=0, T=0, R=0)
    return [_header(params, rows, cols, image_crc(planes[i]))
            + words_to_bytes(words[i], int(nbits[i])) for i in range(P)]


def _encode_planes_native(planes: np.ndarray, res: torch.Tensor,
                          cols: int) -> list[bytes]:
    """The residuals fetched, their runs coded by the native EG coder (JAX
    :920)."""
    res_bits = bitpack.np_unpack(res.cpu().numpy().view(np.uint32), cols)
    return [_encode_medrle(planes[i], residual=res_bits[i].astype(np.uint8))
            for i in range(planes.shape[0])]


def encode_planes_rans(planes: np.ndarray, params: CodecParams | None = None,
                       *, device="cuda") -> list[bytes]:
    """Codec-13 mode-2 streams of a bitplane stack (JAX :751): the stack
    uploaded packed and unpacked on `device`, its context maps, counts and
    tables built there batched, one K7 launch for every stripe of every
    plane (``ransdevice.rans_stack_encode``); the host serializes each
    plane.  The stripe count is re-derived from the stripe height, as in
    ``encode_scab``."""
    planes = np.asarray(planes, dtype=bool)
    P, rows, cols = planes.shape
    params = params or CodecParams(codec=SCAB_CODEC, W=0, T=0, R=0)
    tmpl, n_stripes, sr = scab_stripes(params, rows)
    n_lanes = ransdevice.N_LANES_DEFAULT
    bits = bitpack.unpack(upload_planes(planes, resolve_device(device)), cols)
    ctx = scab_ctx_map(bits, tmpl=tmpl, stripe_rows=sr)
    fields = fetch_rans_stack(ransdevice.rans_stack_encode(
        bits, ctx, stripe_rows=sr, n_lanes=n_lanes))
    return [_header(params, rows, cols, image_crc(planes[i]))
            + _serialize_scab_rans(f, tmpl, n_stripes, sr, n_lanes)
            for i, f in enumerate(fields)]
