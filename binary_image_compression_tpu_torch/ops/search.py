"""Tile grid geometry and the banded distance maps.

Counterpart of ``tile_origins`` (:35) and ``window_distance_maps_banded``
(:185) in ``binary_image_compression_tpu/ops/search.py``.
"""

from __future__ import annotations

import torch


def tile_origins(rows: int, cols: int, W: int, device=None):
    """Raster-order (i0, j0) int64 [T] of the ceil-div tile grid, and (ny, nx)
    (reference compress8_test.cpp:110-111)."""
    ny, nx = -(-rows // W), -(-cols // W)
    ii, jj = torch.meshgrid(torch.arange(ny, device=device),
                            torch.arange(nx, device=device), indexing="ij")
    return (ii * W).reshape(-1), (jj * W).reshape(-1), ny, nx


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of all 64 bits of an int64 tensor (the masks clear the
    bits that arithmetic right shifts bring in; the product wraps)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return ((x * 0x0101010101010101) >> 56) & 0xFF


def banded_origins(gh: int, gw: int, W: int, R: int, device=None,
                   row0: int = 0):
    """(oy, ox) int64 [T]: each tile's clipped map origin, as the JAX
    package clips its band and column slices (search.py:218, :234).  gh is
    the frame's height and its tile rows start at frame row row0 (0 for a
    padded tile grid; R for a shard's frame, parallel/tileshard.py)."""
    Hp, Wp = gh - W + 1, gw - W + 1
    wh, ww = R + 1, 2 * R + W + 1
    i0, j0, _, _ = tile_origins(gh - row0, gw, W, device)
    i0 = i0 + row0
    oy = torch.clamp(i0 - R, min=0, max=max(Hp + max(0, wh - Hp) - wh, 0))
    ox = torch.clamp(j0 - R, min=0, max=max(Wp + max(0, ww - Wp) - ww, 0))
    return oy, ox


def window_distance_maps_banded(E: torch.Tensor, ny: int, nx: int, W: int,
                                R: int, row0: int = 0):
    """Distances from each tile to every cell of its search map: the map
    half of K4's plain version (``select_windows.select_windows_plain``).

    E: int64 [B, He, nx*W] W-bit row-field plane of the padded tile grids
    (``fused_search._field_plane``), W <= 64; rows and columns the maps read
    past it are zero.  Returns (d, oy, ox): d int32 [B, T, R+1, 2R+W+1],
    cell (r, c) of tile t being candidate (oy[t] + r, ox[t] + c), with oy,
    ox int64 [T] from ``banded_origins``.  The tile rows start at frame row
    row0 of E, and oy is in frame rows.  Every cell inside the tile's window
    is exact; cells outside it (past the image, or beyond the window) hold
    arbitrary values that selection never reads.

    d = sum_a popcount(E[y+a, x] ^ E[i0+a, j0]), one tile row at a time, so
    memory stays at B * nx * (R+1) * (2R+W+1) words per step.  The JAX
    package contracts bf16 patches on the MXU instead; both give the same
    integers."""
    B, He, gw = E.shape
    dev = E.device
    wh, ww = R + 1, 2 * R + W + 1
    oy, ox = banded_origins(row0 + ny * W, gw, W, R, dev, row0=row0)
    # rows and columns that any map reads, zero past the plane
    Hm = int(oy.max()) + wh + W - 1
    Wm = int(ox.max()) + ww
    F = torch.nn.functional.pad(E, (0, max(Wm - gw, 0), 0, max(Hm - He, 0)))
    cidx = (ox[:nx, None] + torch.arange(ww, device=dev)).reshape(-1)
    j0 = torch.arange(nx, device=dev) * W
    d = torch.empty((B, ny, nx, wh, ww), dtype=torch.int32, device=dev)
    for ti in range(ny):
        i0, base = row0 + ti * W, int(oy[ti * nx])
        tf = F[:, i0:i0 + W, j0]                                 # [B, W, nx]
        acc = torch.zeros((B, wh, nx, ww), dtype=torch.int64, device=dev)
        for a in range(W):
            band = F[:, base + a:base + a + wh, cidx].reshape(B, wh, nx, ww)
            acc += _popcount64(band ^ tf[:, a, None, :, None])
        d[:, ti] = acc.permute(0, 2, 1, 3)
    return d.reshape(B, ny * nx, wh, ww), oy, ox
