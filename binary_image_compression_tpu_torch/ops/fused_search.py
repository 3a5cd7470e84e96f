"""Kernel K1: windowed Hamming search + serial-scan selection, per tile.

Counterpart of the K1 half of ``binary_image_compression_tpu/ops/
pallas_kernels.py``: ``_key_span`` (:92), ``packed_sel_layout`` (:207),
``_packed_window_keys`` (:243), ``_packed_priority`` (:278),
``_packed_decode`` (:296), ``_field_plane`` (:451), ``fused_supported``
(:525) and ``fused_search_select`` (:541).

For every tile (i0, j0) of every page, each candidate (y, x) of its causal
search window gets the Hamming distance d = sum_a popcount(E[y+a, x] ^
E[i0+a, j0]) over the W-bit row-field plane E, and the reference serial scan
(first candidate with d' <= T in scan order, else the first strict minimum of
d', with d' = min(d, M-d) under inversion) is ONE min over a packed
(stop, d', key, inv) priority.  The priority is 64-bit here, so one kernel
covers every shape, including those where the JAX package's 32-bit layout
does not fit and it takes the masked-grid selection instead (W=32 with
R >= 172, for example); both JAX paths give the same 8 outputs.

The tiles may start below the top of the frame the plane is built from:
``row0`` is the frame row of the first tile row and ``y_base`` the absolute
image row of frame row 0.  Tile sharding (``parallel/tileshard.py``)
searches a shard's frame (R halo rows from the shards above, then its own
tile rows) with row0 = R and y_base = the shard's first row - R: bands and
gathers stay in frame rows, masks and ranks use absolute rows.

``fused_search_select`` launches two CUDA kernels (``csrc/fused_search.cu``)
for CUDA tensors, the field plane (counted as ``field_plane``) and the
search (``fused_search_select``), and runs their plain versions,
``_field_plane`` and ``fused_search_select_plain``, for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .bitpack import from_i32, popcount, to_i32

INF = 1 << 62            # priority of a non-candidate (64-bit layout)
OUT_FIELDS = ("bestd", "dy", "inv", "found", "rank", "n_cands", "has_cands",
              "dx")


def _key_span(W: int, R: int) -> int:
    """Scan-key row stride: > any per-row x extent (2R+W+1), so keys order
    candidates (y desc, x desc within each grid; grid 1 before grid 2) and
    stay window-relative whatever the image width."""
    return 2 * R + W + 2


def packed_sel_layout(W: int, R: int):
    """Bit layout of the 64-bit packed selection priority, or None.

        p = stop ? key << (db+1) | d' << 1 | inv              (< FLAG)
                 : FLAG | d' << (kb+1) | key << 1 | inv

    Scan keys are unique per candidate, so the minimum of p is the serial
    scan's outcome and the winner's coordinates decode from its key.
    Requires R >= W (the band covers grid-1 rows i0-W..i0 only then)."""
    if R < W:
        return None
    M = W * W
    span = _key_span(W, R)
    off1 = (W + 2) * span
    keymax = off1 + (R - W + 1) * span   # grid-2 rows span R - W rows, + slack
    kb = keymax.bit_length()
    db = M.bit_length()                  # d' <= M
    if db + kb + 3 > 62:                 # FLAG | d' | key | inv < INF = 2^62
        return None
    return dict(span=span, off1=off1, kb=kb, db=db, flag=1 << (db + kb + 2))


def fused_supported(ny: int, nx: int, W: int, R: int) -> bool:
    """Shapes the fused path covers, the same set as the JAX package's.

    W <= 32 (a tile row field per 32-bit word) and R >= W; the band bound is
    the JAX package's VMEM budget, kept so both packages route the same
    shapes (the rest take the banded search, K4 ``select_windows``)."""
    if W > 32 or R < W:
        return False
    k = next((kk for kk in (4, 3, 2) if W * kk <= 32 and W % kk == 0), 1)
    nit = W // k
    return (R + nit) * nx * W * 4 <= 4 * 2 ** 20


def plane_height(gh: int, W: int, R: int) -> int:
    """Rows He of the field plane: the padded grid plus the zero rows that
    let a bottom tile's band of R+1 candidate rows stay inside the plane."""
    return gh + max(0, (R + 1) - (gh - W + 1))


def band_origins(ny: int, W: int, R: int, He: int, device=None,
                 row0: int = 0):
    """oy [ny]: first band row per tile row, clip(i0 - R, 0, He - W - R)
    with i0 = row0 + the tile row's offset, in frame rows
    (pallas_kernels.py:603)."""
    i0 = row0 + torch.arange(ny, device=device, dtype=torch.int64) * W
    return torch.clamp(i0 - R, min=0, max=max(He - W - R, 0))


def _field_plane(img: torch.Tensor, W: int, He: int, We: int) -> torch.Tensor:
    """E[b, y, x] = the W-bit row field img[b, y, x:x+W] (bits W-1..0) as
    int64; rows past the image and columns past its right edge read 0.
    The plain version of the plane kernel (``_launch_plane``)."""
    B, gh, gw = img.shape
    imgp = torch.zeros((B, He, We + W), dtype=torch.int64, device=img.device)
    imgp[:, :gh, :gw] = img.to(torch.int64)
    E = torch.zeros((B, He, We), dtype=torch.int64, device=img.device)
    for a in range(W):
        E |= imgp[:, :, a:a + We] << (W - 1 - a)
    return E


def _packed_window_keys(i0, j0, y, x, *, W, R, cols, lay, grids=(1, 2)):
    """Scan keys and validity for broadcastable absolute (i0, j0, y, x).

    grids restricts the window grids that contribute: strict mode scores
    grid 2 per tile row and grid 1 per tile; a cell in both grids then
    gives two priorities whose minimum is the combined cell's."""
    span, off1 = lay["span"], lay["off1"]
    minj = torch.clamp(j0 - R, min=0)
    maxj2 = torch.clamp(j0 - W, min=0)
    maxj = torch.clamp(j0 + R, max=cols - W)
    in1 = ((y >= torch.clamp(i0 - W, min=0)) & (y <= i0)
           & (x >= minj) & (x <= maxj2) & (j0 >= W) & (1 in grids))
    in2 = ((y >= torch.clamp(i0 - R, min=0)) & (y <= i0 - W)
           & (x >= minj) & (x <= maxj) & (2 in grids))
    key1 = torch.where(in1, (i0 - y) * span + (maxj2 - x), INF)
    key2 = torch.where(in2, off1 + (i0 - W - y) * span + (maxj - x), INF)
    return torch.minimum(key1, key2), in1 | in2


def _packed_priority(d, key, valid, *, M, T_thresh, invert, lay):
    """The packed (stop, d', key, inv) priority, INF off-window."""
    kb, db = lay["kb"], lay["db"]
    if invert:
        dp = torch.minimum(d, M - d)
        invb = ((M - d) < d).to(torch.int64)
    else:
        dp = d
        invb = torch.zeros_like(d)
    keyv = torch.where(valid, key, 0)
    p = torch.where(dp <= T_thresh,
                    (keyv << (db + 1)) | (dp << 1) | invb,
                    lay["flag"] | (dp << (kb + 1)) | (keyv << 1) | invb)
    return torch.where(valid, p, INF)


def _packed_decode(pr, i0, j0, oy, *, W, R, cols, lay):
    """Decode packed minima into the 8 selection outputs, int64 [..., 8].

    pr/i0/j0/oy broadcast (absolute i0/oy).  Scan-key decode plus the
    closed-form rectangle counts for n_cands and rank."""
    span, off1, kb, db = lay["span"], lay["off1"], lay["kb"], lay["db"]
    minj = torch.clamp(j0 - R, min=0)
    maxj2 = torch.clamp(j0 - W, min=0)
    maxj = torch.clamp(j0 + R, max=cols - W)

    found = pr < INF
    is_stop = pr < lay["flag"]
    kmask, dmask = (1 << kb) - 1, (1 << db) - 1
    key_sel = torch.where(is_stop, pr >> (db + 1), (pr >> 1) & kmask)
    bestd = torch.where(is_stop, (pr >> 1) & dmask, (pr >> (kb + 1)) & dmask)
    inv = pr & 1

    g2 = key_sel >= off1
    q = torch.where(g2, key_sel - off1, key_sel)           # q >= 0
    ry = torch.div(q, span, rounding_mode="floor")
    xt = q - ry * span
    y = torch.where(g2, i0 - W - ry, i0 - ry)
    x = torch.where(g2, maxj - xt, maxj2 - xt)
    zero = torch.zeros_like(pr)
    dy = torch.where(found, y - oy, zero)
    dx = torch.where(found, x, zero)
    inv = torch.where(found, inv, zero)
    bestd = torch.where(found, bestd, zero)

    # both window grids are rectangles in (scan-row, scan-col) space; with
    # R < W (strict mode only) both are empty and the counts clamp to 0
    r1 = torch.clamp(i0, max=W) + 1
    c1 = torch.where(j0 >= W, torch.clamp(maxj2 - minj + 1, min=0), 0)
    r2 = torch.clamp(i0 - W - torch.clamp(i0 - R, min=0) + 1, min=0)
    c2 = maxj - minj + 1
    n_cands = r1 * c1 + r2 * c2

    def count_lt(ks, c, r):
        # |{(ry, xt): 0 <= ry < r, 0 <= xt < c, ry*span + xt < ks}|, c < span
        nf = torch.where(ks >= c, torch.div(ks - c, span,
                                            rounding_mode="floor") + 1, 0)
        nf = torch.minimum(torch.clamp(nf, min=0), r)
        rem = torch.minimum(torch.clamp(ks - nf * span, min=0), c)
        part = torch.where(nf < r, rem, 0)
        return torch.where((c > 0) & (ks > 0), nf * c + part, 0)

    rank = count_lt(key_sel, c1, r1) + count_lt(
        torch.where(g2, key_sel - off1, -1), c2, r2)
    rank = torch.where(found, rank, zero)
    has_cands = (n_cands > 0).to(torch.int64)
    shape = pr.shape
    return torch.stack([t.expand(shape) for t in (
        bestd, dy, inv, found.to(torch.int64), rank, n_cands, has_cands, dx)],
        dim=-1)


def fused_search_select_plain(E, ny, nx, *, W, R, T_thresh, cols, invert,
                              y_base=0, row0=0):
    """Plain PyTorch K1: E int32 [B, He, We] -> int32 [B, ny*nx, 8].

    Chunked per tile row: each row's tiles score the 2R+1 window columns of
    R+1 band rows, words as int64 with SWAR popcount."""
    lay = packed_sel_layout(W, R)
    B, He, We = E.shape
    dev = E.device
    M = W * W
    Ew = from_i32(E)
    # R zero columns either side: tile tj's window columns are j0-R..j0+R
    Ep = torch.nn.functional.pad(Ew, (R, R))
    win = 2 * R + 1
    j0 = torch.arange(nx, device=dev, dtype=torch.int64) * W
    xs = j0[:, None] - R + torch.arange(win, device=dev)         # [nx, win]
    rr = torch.arange(R + 1, device=dev, dtype=torch.int64)
    oy_all = band_origins(ny, W, R, He, device=dev, row0=row0)
    out = torch.empty((B, ny, nx, 8), dtype=torch.int64, device=dev)
    for ti in range(ny):
        i0 = row0 + ti * W
        oy = int(oy_all[ti])
        tf = Ew[:, i0:i0 + W, j0]                                # [B, W, nx]
        d = torch.zeros((B, R + 1, nx, win), dtype=torch.int64, device=dev)
        for a in range(W):
            band = Ep[:, oy + a:oy + a + R + 1].unfold(2, win, W)
            d += popcount(band ^ tf[:, a, None, :, None])
        # absolute coordinates drive the masks and keys
        i0a = torch.tensor(i0 + y_base, device=dev)
        oya = torch.tensor(oy + y_base, device=dev)
        key, valid = _packed_window_keys(
            i0a, j0[None, :, None], (oya + rr)[:, None, None], xs[None],
            W=W, R=R, cols=cols, lay=lay)
        p = _packed_priority(d, key[None], valid[None], M=M,
                             T_thresh=T_thresh, invert=invert, lay=lay)
        pr = p.amin(dim=(1, 3))                                  # [B, nx]
        out[:, ti] = _packed_decode(pr, i0a, j0[None], oya, W=W, R=R,
                                    cols=cols, lay=lay)
    return out.reshape(B, ny * nx, 8).to(torch.int32)


def fused_search_select(img_bits, ny: int, nx: int, *, W: int, R: int,
                        T_thresh: int, cols: int, invert: bool,
                        y_base: int = 0, row0: int = 0):
    """K1 over a batch of pages.

    img_bits: 0/1 [B, gh, nx*W] frames whose ny tile rows start at frame row
    row0 (gh = row0 + ny*W; a padded tile grid has row0 = 0).  y_base is the
    absolute image row of frame row 0 (masks and ranks use absolute rows;
    gathers stay frame-relative).  Returns (sel int32 [B, T, 8] with columns
    OUT_FIELDS, oy int64 [T] band origins in frame rows, E int32 [B, He, We]
    field plane as uint32 bit patterns).  Shapes outside ``fused_supported``
    raise NotImplementedError.
    """
    B, gh, gw = img_bits.shape
    if not fused_supported(ny, nx, W, R) or packed_sel_layout(W, R) is None:
        raise NotImplementedError(
            f"W={W}, R={R}, {ny}x{nx} tiles: outside the fused search; "
            "compress.encode_analyze takes the banded route (K4, "
            "select_windows) for this shape")
    if row0 < 0 or row0 + ny * W > gh:
        raise ValueError(f"{ny} tile rows from frame row {row0} do not fit "
                         f"a frame of {gh} rows")
    He = plane_height(gh, W, R)
    kw = dict(W=W, R=R, T_thresh=T_thresh, cols=cols, invert=invert,
              y_base=y_base, row0=row0)
    if img_bits.is_cuda:
        E = _launch_plane(img_bits, W, He)
        sel = _launch(E, ny, nx, **kw)
    elif img_bits.device.type == "cpu":
        E = to_i32(_field_plane(img_bits, W, He, gw))
        sel = fused_search_select_plain(E, ny, nx, **kw)
    else:
        raise RuntimeError(f"K1 has no kernel for device {img_bits.device}")
    oy = band_origins(ny, W, R, He, device=E.device,
                      row0=row0).repeat_interleave(nx)
    return sel, oy, E


def _launch_plane(img_bits, W: int, He: int):
    """Launch the plane kernel of csrc/fused_search.cu: 0/1 [B, gh, gw] ->
    int32 [B, He, gw], one thread per field."""
    if img_bits.dim() != 3 or not 1 <= W <= 32 or He < img_bits.shape[1]:
        raise ValueError("the plane kernel takes 0/1 [B, gh, gw] pages, "
                         "W <= 32 and He >= gh")
    img = img_bits.contiguous()
    img = img.view(torch.uint8) if img.dtype == torch.bool \
        else img.to(torch.uint8)
    B, gh, gw = img.shape
    E = torch.empty((B, He, gw), dtype=torch.int32, device=img.device)
    _cuda.check(_cuda.get_lib().bic_field_plane(
        ctypes.c_void_p(img.data_ptr()), ctypes.c_void_p(E.data_ptr()),
        B, gh, gw, He, W, _cuda.stream(img.device)), "bic_field_plane")
    _cuda.launches["field_plane"] += 1
    return E


def _launch(E, ny, nx, *, W, R, T_thresh, cols, invert, y_base, row0=0):
    """Launch the search kernel of csrc/fused_search.cu: one block per
    (tile, page)."""
    if E.dtype != torch.int32 or E.dim() != 3 or not E.is_contiguous():
        raise ValueError("K1 takes a contiguous int32 [B, He, We] plane")
    lay = packed_sel_layout(W, R)
    B, He, We = E.shape
    T = ny * nx
    out = torch.empty((B, T, 8), dtype=torch.int32, device=E.device)
    lib = _cuda.get_lib()
    _cuda.check(lib.bic_fused_search_select(
        ctypes.c_void_p(E.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, He, We, nx, T, W, R, T_thresh, cols, int(invert), y_base, row0,
        lay["span"], lay["off1"], lay["kb"], lay["db"],
        _cuda.stream(E.device)), "bic_fused_search_select")
    _cuda.launches["fused_search_select"] += 1
    return out
