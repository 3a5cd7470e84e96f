"""Kernel K4: the banded windowed search and serial-scan selection, W <= 64.

Counterpart of ``select_windows`` (:407) in ``binary_image_compression_tpu/
ops/pallas_kernels.py``, whose kernel runs the masked-grid
``_selection_scalars`` (:147) on one tile's map per grid step, together
with the distance maps that feed it (``search.window_distance_maps_banded``,
:185 of the JAX package's ``ops/search.py``).  It takes the shapes K1 does
not: W from 33 to 64, and bands over K1's budget.

Per tile, each candidate (y, x) of the causal window gets the Hamming
distance to the tile over the W-bit row-field plane (one int64 word per
field, so W = 64 fits) and the packed (stop, d', key, inv) priority of K1
(``fused_search.packed_sel_layout``, 64-bit, so every W <= 64 fits); one
min over them is the reference serial scan's outcome (stop-first, then the
strict minimum of d' in scan order), and ``fused_search._packed_decode``
turns it into the 8 outputs, with n_cands and rank counting the y = i0-W row
in both grids.  The closed-form counts equal the JAX kernel's masked sums
because the band covers the whole window (R >= W).

Output columns are K1's (``fused_search.OUT_FIELDS``): column 1 is dy
relative to the banded origin oy (``search.banded_origins``) and column 7
the absolute x, where the JAX kernel returns x relative to ox.

As in K1, ``row0`` is the frame row of the first tile row and ``y_base``
the absolute row of frame row 0 (``parallel/tileshard.py`` searches a
shard's frame with row0 = R): the windows, the top clamp and the keys use
absolute rows, the loads and oy frame rows.

``select_windows`` launches two CUDA kernels (``csrc/select_windows.cu``)
for CUDA tensors, the 64-bit field plane (counted as ``banded_plane``) and
the search (``select_windows``), and runs their plain versions,
``fused_search._field_plane`` and ``select_windows_plain`` (the banded
distance maps, then ``select_maps``), for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, search
from .fused_search import (_field_plane, _packed_decode, _packed_priority,
                           _packed_window_keys, packed_sel_layout,
                           plane_height)


def _layout(W: int, R: int) -> dict:
    lay = packed_sel_layout(W, R)
    if lay is None or W > 64:
        raise ValueError(f"the banded search needs W <= 64, R >= W and a "
                         f"64-bit priority (W={W}, R={R})")
    return lay


def _tile_coords(T: int, nx: int, W: int, device):
    t = torch.arange(T, device=device)
    return (t // nx) * W, (t % nx) * W


def select_maps(d, oy, ox, nx: int, *, W: int, R: int, T_thresh: int,
                cols: int, invert: bool, y_base: int = 0, row0: int = 0):
    """The selection over distance maps: d int32 [B, T, h, w], cell (r, c)
    of tile t being candidate (oy[t] + r, ox[t] + c) -> int32 [B, T, 8].
    oy is in frame rows; tile t's frame row is row0 + its grid offset, and
    frame row f is absolute row f + y_base.

    One tile row at a time, so the key and priority tensors stay at
    B * nx * h * w elements."""
    lay = _layout(W, R)
    B, T, h, w = d.shape
    dev = d.device
    i0, j0 = _tile_coords(T, nx, W, dev)
    i0 = i0 + row0 + y_base                       # absolute rows from here
    oy = oy + y_base
    rr = torch.arange(h, device=dev)
    cc = torch.arange(w, device=dev)
    out = torch.empty((B, T, 8), dtype=torch.int32, device=dev)
    for t0 in range(0, T, nx):
        s = slice(t0, t0 + nx)
        y = (oy[s, None] + rr)[:, :, None]                       # [n, h, 1]
        x = (ox[s, None] + cc)[:, None, :]                       # [n, 1, w]
        key, valid = _packed_window_keys(
            i0[s, None, None], j0[s, None, None], y, x, W=W, R=R, cols=cols,
            lay=lay)
        p = _packed_priority(d[:, s].to(torch.int64), key[None], valid[None],
                             M=W * W, T_thresh=T_thresh, invert=invert,
                             lay=lay)
        pr = p.amin(dim=(2, 3))                                  # [B, n]
        out[:, s] = _packed_decode(pr, i0[None, s], j0[None, s], oy[None, s],
                                   W=W, R=R, cols=cols, lay=lay).to(
                                       torch.int32)
    return out


def select_windows_plain(E, ny: int, nx: int, *, W: int, R: int,
                         T_thresh: int, cols: int, invert: bool,
                         y_base: int = 0, row0: int = 0):
    """Plain PyTorch K4: the int64 field plane [B, He, nx*W] -> int32
    [B, ny*nx, 8]: the banded distance maps, then ``select_maps``."""
    d, oy, ox = search.window_distance_maps_banded(E, ny, nx, W, R,
                                                   row0=row0)
    return select_maps(d, oy, ox, nx, W=W, R=R, T_thresh=T_thresh,
                       cols=cols, invert=invert, y_base=y_base, row0=row0)


def select_windows(img_bits, ny: int, nx: int, *, W: int, R: int,
                   T_thresh: int, cols: int, invert: bool, y_base: int = 0,
                   row0: int = 0):
    """K4 over a batch of pages.

    img_bits: 0/1 [B, gh, nx*W] frames whose ny tile rows start at frame row
    row0 (gh = row0 + ny*W; a padded tile grid has row0 = 0); y_base is the
    absolute row of frame row 0.  Returns (sel int32 [B, T, 8] with columns
    ``fused_search.OUT_FIELDS``, oy int64 [T] banded origins in frame rows,
    E int64 [B, He, nx*W] the field plane as uint64 bit patterns, He =
    ``fused_search.plane_height``)."""
    _layout(W, R)
    B, gh, gw = img_bits.shape
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
        E = _field_plane(img_bits, W, He, gw)
        sel = select_windows_plain(E, ny, nx, **kw)
    else:
        raise RuntimeError(f"K4 has no kernel for device {img_bits.device}")
    oy, _ = search.banded_origins(gh, gw, W, R, E.device, row0=row0)
    return sel, oy, E


def _launch_plane(img_bits, W: int, He: int):
    """Launch the plane kernel of csrc/select_windows.cu: 0/1 [B, gh, gw] ->
    int64 [B, He, gw], one thread per field."""
    if img_bits.dim() != 3 or not 1 <= W <= 64 or He < img_bits.shape[1]:
        raise ValueError("the banded plane kernel takes 0/1 [B, gh, gw] "
                         "pages, W <= 64 and He >= gh")
    img = img_bits.contiguous()
    img = img.view(torch.uint8) if img.dtype == torch.bool \
        else img.to(torch.uint8)
    B, gh, gw = img.shape
    E = torch.empty((B, He, gw), dtype=torch.int64, device=img.device)
    _cuda.check(_cuda.get_lib().bic_banded_plane(
        ctypes.c_void_p(img.data_ptr()), ctypes.c_void_p(E.data_ptr()),
        B, gh, gw, He, W, _cuda.stream(img.device)), "bic_banded_plane")
    _cuda.launches["banded_plane"] += 1
    return E


def _launch(E, ny, nx, *, W, R, T_thresh, cols, invert, y_base=0, row0=0):
    """Launch the search of csrc/select_windows.cu: a few blocks per (tile,
    page) merged by atomicMin, then the decode."""
    if E.dtype != torch.int64 or E.dim() != 3 or not E.is_contiguous():
        raise ValueError("K4 takes a contiguous int64 [B, He, We] plane")
    lay = _layout(W, R)
    B, He, We = E.shape
    if He < W + R or We < nx * W or row0 + ny * W > He:
        raise ValueError(f"K4: a plane of {He} x {We} does not hold the "
                         f"bands of {ny} x {nx} tiles (W={W}, R={R})")
    T = ny * nx
    best = torch.empty((B, T), dtype=torch.int64, device=E.device)
    out = torch.empty((B, T, 8), dtype=torch.int32, device=E.device)
    _cuda.check(_cuda.get_lib().bic_select_windows(
        ctypes.c_void_p(E.data_ptr()), ctypes.c_void_p(best.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), B, He, We, nx, T, W, R, T_thresh,
        cols, int(invert), y_base, row0, lay["span"], lay["off1"],
        lay["kb"], lay["db"],
        _cuda.stream(E.device)), "bic_select_windows")
    _cuda.launches["select_windows"] += 1
    return out
