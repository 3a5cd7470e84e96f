"""The codec-8 encoders: device analysis + native record packing.

Counterpart of ``binary_image_compression_tpu/models/compress.py``:
``encode_analyze`` (:70, fused and banded variants),
``_finish_selection`` (:186), ``_finish_selection_fields`` (:232),
``encode_analyze_decided`` (:278), ``_split_decided`` / ``_pack_decided``
(:322-356), ``_decide_modes`` (:359), ``encode`` (:397), ``encode_batch``
(:483) and ``encode_strict`` (:1049).

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
substitution chain and yields the same record block.  Then per page on the
host, native ``bic_pack_tiles`` writes the stream.  Streams are
byte-identical to the JAX package's and the host encoder's.
"""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np
import torch

from .. import native
from ..ops import (bitpack, decide, fused_search, search, select_windows,
                   strict)
from ..ops._cuda import resolve_device
from ..ops.bitstream import BitWriter, enum_encode, enum_nbits, golomb_encode
from ..ops.entropy import GolombCoder
from .codec import CodecParams, _check_W, _header, image_crc

# pages the native host encoder took: causal R < W, strict shapes outside
# strict.supported, strict archive pages (not a device launch)
host_route = collections.Counter()


def _check_causal8(params):
    if params.codec != 8:
        raise NotImplementedError(
            f"codec {params.codec}: compress encodes codec 8 only (codec 11 "
            "is codec.encode; codecs 4/7 are ROADMAP.md Queue 1 item 12; 13 "
            "is item 7)")
    if params.strict:
        raise ValueError("strict mode is encoded by compress.encode_strict")


def _med_tiles(P: torch.Tensor) -> torch.Tensor:
    """MED residual on dense [..., W, W] tiles (invertible origin)."""
    F = torch.nn.functional
    up = F.pad(P, (0, 0, 1, 0))[..., :-1, :]
    left = F.pad(P, (1, 0))[..., :-1]
    upleft = F.pad(P, (1, 0, 1, 0))[..., :-1, :-1]
    return P ^ up ^ left ^ upleft


def _selection_coords(sel, oy, W, nx):
    """(b, ysel, xsel, i0, j0) gather coordinates, each [B, T]."""
    B, T, _ = sel.shape
    i0, j0, _, _ = search.tile_origins(T // nx * W, nx * W, W, sel.device)
    ysel = oy[None] + sel[..., 1].to(torch.int64)
    xsel = sel[..., 7].to(torch.int64)
    b = torch.arange(B, device=sel.device)[:, None]
    return b, ysel, xsel, i0[None], j0[None]


def _finish_selection_fields(plane, sel, oy, *, W: int, nx: int):
    """Field-domain finish (requires 32 % W == 0): the selected candidate and
    the tile are [B, T, W] gathers of row fields from K1's plane; inversion,
    MED, weights and the residual words are field arithmetic."""
    b, ysel, xsel, i0, j0 = _selection_coords(sel, oy, W, nx)
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


def _finish_selection(img, sel, oy, *, W: int, nx: int):
    """Dense finish for 32 % W != 0: [B, T, W, W] pixel gathers; residuals
    packed with bitpack.pack."""
    b, ysel, xsel, i0, j0 = _selection_coords(sel, oy, W, nx)
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


def finish_analysis(img, sel, oy, plane, *, W: int, nx: int) -> dict:
    """The finish after the selection: the dict ``encode_analyze`` returns.
    The field finish reads K1's 32-bit plane; the banded route (plane
    None) takes the dense finish."""
    if plane is not None and 32 % W == 0:
        weights4, residual4 = _finish_selection_fields(plane, sel, oy, W=W,
                                                       nx=nx)
    else:
        weights4, residual4 = _finish_selection(img, sel, oy, W=W, nx=nx)
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


def _pack_decided(out: dict, hdr: bytes, M: int) -> bytes:
    """Encoder tail: native bic_pack_tiles over the decided records."""
    res_bits = bitpack.np_unpack(out["residual"], M)
    return native.pack_tiles(hdr, M, out["mode"], out["inv"],
                             out["rank"].astype(np.int64), out["idx_len"],
                             out["weight"], res_bits.astype(np.uint8))


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
    and strict shapes outside ``strict.supported``."""
    host_route["pages"] += 1
    hdr = _header(params, *img.shape, image_crc(img))
    return native.encode_windowed(img, hdr, params.codec, params.strict,
                                  params.W, params.resolved_T(), params.R)


def _upload(pages: np.ndarray, W: int, dev) -> torch.Tensor:
    """Zero-pad bool [B, rows, cols] to the tile grid, pack to uint32 words
    and upload them as int32 [B, ny*W, nwords(nx*W)]."""
    B, rows, cols = pages.shape
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((B, ny * W, nx * W), dtype=bool)
    grid[:, :rows, :cols] = pages
    packed = bitpack.np_pack(grid).view(np.int32)
    return torch.from_numpy(packed).to(dev)


def encode(img: np.ndarray, params: CodecParams | None = None, *,
           device="cuda") -> bytes:
    """Encode one page (codec 8, causal): device analysis on `device`, host
    record packing.  Byte-identical to the host encoder."""
    return encode_batch(np.asarray(img, dtype=bool)[None], params,
                        device=device)[0]


def encode_batch(pages: np.ndarray, params: CodecParams | None = None, *,
                 device="cuda") -> list[bytes]:
    """Encode same-sized pages bool [B, rows, cols]: one K1 and one K2 launch
    for the whole batch, then the native pack per page on host threads."""
    params = params or CodecParams(codec=8, strict=False)
    _check_causal8(params)
    _check_W(params)
    pages = np.asarray(pages, dtype=bool)
    if params.R < params.W:
        return [host_encode(p, params) for p in pages]
    dev = resolve_device(device)
    _, rows, cols = pages.shape
    block = encode_analyze_decided(
        _upload(pages, params.W, dev), W=params.W, R=params.R,
        T_thresh=params.resolved_T(), rows=rows, cols=cols).cpu().numpy()
    return pack_pages(block, pages, params)


def pack_pages(block: np.ndarray, pages: np.ndarray,
               params: CodecParams) -> list[bytes]:
    """Native record packing of a fetched [B, T, 2 + nw] block, one page
    per host thread."""
    B, rows, cols = pages.shape

    def build(b):
        hdr = _header(params, rows, cols, image_crc(pages[b]))
        return _pack_decided(_split_decided(block[b]), hdr,
                             params.W * params.W)

    workers = min(B, os.cpu_count() or 1)
    if workers <= 1:
        return [build(b) for b in range(B)]
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(build, range(B)))


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
    return pack_pages(block[None].cpu().numpy(), img[None], params)[0]
