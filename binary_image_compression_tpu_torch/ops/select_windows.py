"""Kernel K4: serial-scan selection over precomputed distance maps.

Counterpart of ``select_windows`` (:407) in ``binary_image_compression_tpu/
ops/pallas_kernels.py``, whose kernel runs the masked-grid
``_selection_scalars`` (:147) on one tile's map per grid step.  The banded
fallback search (``search.window_distance_maps_banded``) feeds it for the
shapes K1 does not take: W from 33 to 64, and bands over K1's budget.

Per tile, each map cell (oy + r, ox + c) inside the causal window gets the
packed (stop, d', key, inv) priority of K1 (``fused_search.
packed_sel_layout``, 64-bit, so every W <= 64 fits); one min over them is
the reference serial scan's outcome (stop-first, then the strict minimum
of d' in scan order), and ``fused_search._packed_decode`` turns it into
the 8 outputs, with n_cands and rank counting the y = i0-W row in both
grids.  The closed-form counts equal the JAX kernel's masked sums because
the banded maps cover the whole window (R >= W).

Output columns are K1's (``fused_search.OUT_FIELDS``): column 1 is dy
relative to oy and column 7 the absolute x, where the JAX kernel returns
x relative to ox.

``select_windows`` launches ``csrc/select_windows.cu`` for CUDA tensors and
runs ``select_windows_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .fused_search import (_packed_decode, _packed_priority,
                           _packed_window_keys, packed_sel_layout)


def _layout(W: int, R: int) -> dict:
    lay = packed_sel_layout(W, R)
    if lay is None:
        raise ValueError(f"selection over banded maps needs R >= W and a "
                         f"64-bit priority (W={W}, R={R})")
    return lay


def _tile_coords(T: int, nx: int, W: int, device):
    t = torch.arange(T, device=device)
    return (t // nx) * W, (t % nx) * W


def select_windows_plain(d, oy, ox, nx: int, *, W: int, R: int,
                         T_thresh: int, cols: int, invert: bool):
    """Plain PyTorch K4: d int32 [B, T, h, w] -> int32 [B, T, 8].

    One tile row at a time, so the key and priority tensors stay at
    B * nx * h * w elements."""
    lay = _layout(W, R)
    B, T, h, w = d.shape
    dev = d.device
    i0, j0 = _tile_coords(T, nx, W, dev)
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


def select_windows(d, oy, ox, nx: int, *, W: int, R: int, T_thresh: int,
                   cols: int, invert: bool):
    """K4 over a batch of pages' maps.

    d: int32 [B, T, h, w] distance maps of the ny x nx tile grid; oy, ox:
    int64 [T] map origins (``search.banded_origins``).  Returns int32
    [B, T, 8] with columns ``fused_search.OUT_FIELDS``."""
    kw = dict(W=W, R=R, T_thresh=T_thresh, cols=cols, invert=invert)
    if d.is_cuda:
        return _launch(d, oy, ox, nx, **kw)
    if d.device.type == "cpu":
        return select_windows_plain(d, oy, ox, nx, **kw)
    raise RuntimeError(f"K4 has no kernel for device {d.device}")


def _launch(d, oy, ox, nx, *, W, R, T_thresh, cols, invert):
    """Launch csrc/select_windows.cu: one block per (tile, page)."""
    if d.dtype != torch.int32 or d.dim() != 4 or not d.is_contiguous():
        raise ValueError("K4 takes contiguous int32 [B, T, h, w] maps")
    lay = _layout(W, R)
    B, T, h, w = d.shape
    oy32 = oy.to(device=d.device, dtype=torch.int32).contiguous()
    ox32 = ox.to(device=d.device, dtype=torch.int32).contiguous()
    if oy32.shape != (T,) or ox32.shape != (T,):
        raise ValueError("K4: oy and ox must be [T]")
    out = torch.empty((B, T, 8), dtype=torch.int32, device=d.device)
    lib = _cuda.get_lib()
    _cuda.check(lib.bic_select_windows(
        ctypes.c_void_p(d.data_ptr()), ctypes.c_void_p(oy32.data_ptr()),
        ctypes.c_void_p(ox32.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, T, h, w, nx, W, R, T_thresh, cols, int(invert), lay["span"],
        lay["off1"], lay["kb"], lay["db"], _cuda.stream(d.device)),
        "bic_select_windows")
    _cuda.launches["select_windows"] += 1
    return out
