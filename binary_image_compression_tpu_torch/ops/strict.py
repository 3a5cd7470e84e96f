"""Kernel K3: the strict-mode (residual-substitution) analysis of one page.

Counterpart of ``binary_image_compression_tpu/ops/pallas_strict.py``:
``supported`` (:55) and ``strict_analyze`` (:61) with its kernel body
(:211-491) in the split form the JAX package runs by default.

Strict mode is the reference's own semantics (compress8_test.cpp:294-300):
each coded tile's pixels are replaced in the working image by its chosen
residual, so later tiles search a mutated image.  Over the tiles of the
page in raster order, on a live W-bit row-field plane E:
  * grid 2 (rows max(i0-R,0)..i0-W) reads only rows that are final once the
    previous tile row is done, so a tile row's grid-2 minima are computed
    together; grid 1 (rows max(i0-W,0)..i0) reads the live rows and is
    scored per tile.  Selection is K1's packed (stop, d', key, inv) minimum
    with the exact R (``fused_search``);
  * the finish in the field domain: p the tile's fields, p2 the selected
    candidate's, p3 = ((inv ? p ^ wmask : p) ^ p2) & wmask, MED of both, and
    the four weights popcount(p3), popcount(MED p3), popcount(p),
    popcount(MED p);
  * the codec-8 mode decision (K2's costs) against two Golomb contexts that
    persist across all tiles of the page;
  * the chosen residual is written back over the tile's pixels: fields at
    x in [j0-W+1, j0+W) of rows [i0, i0+W) change.

Outputs per tile: int32 [T, 8] with columns ``OUT_FIELDS`` and the W
residual fields, int32 [T, W] (uint32 bit patterns; ``bitpack.
fields_to_words`` packs them as the JAX package does, pallas_strict.py:
163-167).

For R < W both window grids are empty: every tile is a nomatch with
n_cands = 0 and bestd = inv = 0.  (The JAX kernel's masked-grid fallback
reports band cell 0's distance and inversion there instead; the stream
reads neither.)

``strict_analyze`` launches ``csrc/strict_analyze.cu`` for CUDA tensors and
runs ``strict_analyze_plain`` for CPU tensors.  ``_plan`` owns the
kernel's launch geometry: how each tile row's grid-2 rows are sliced
across blocks, and whether the serial pass keeps its live band in a
shared-memory ring (and of what size) or in global memory; every shape
``supported`` takes has one.  The kernel only checks that the plan covers
what it reads.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .bitpack import U32, med_fields, popcount, to_i32
from .decide import BIG, idx_len, mode_costs
from .fused_search import (INF, _field_plane, _packed_decode,
                           _packed_priority, _packed_window_keys,
                           packed_sel_layout)

OUT_FIELDS = ("mode", "rank", "inv", "weight", "k_used", "n_cands",
              "idx_len", "bestd")

RUN2 = 8             # slices of whole 8-row runs, the grid-2 kernel's items
G2_BLOCKS = 264      # grid-2 blocks to aim for per tile row: 2 per H100 SM
SMEM_MAX = 232448    # shared memory one block may use on the H100
SMEM_STATIC = 1024   # the serial pass's static shared memory, rounded up


def supported(W: int, R: int) -> bool:
    """Shapes the strict kernel takes, the same set as the JAX package's
    (the JAX band starts roundup8(R) rows above each tile and must reach
    the grid-1 rows); the rest go to the native host encoder."""
    return W in (8, 16, 24, 32) and R >= 1 and max(8, -(-R // 8) * 8) >= W


def _layout(W: int, R: int) -> dict:
    """K1's 64-bit priority layout.  For R < W no key is ever packed (both
    grids are empty), so the R = W layout stands in."""
    lay = packed_sel_layout(W, max(R, W))
    if lay is None:
        raise ValueError(f"strict mode: no 64-bit priority layout for W={W}, "
                         f"R={R}")
    return lay


def _check(img_bits: torch.Tensor, enb: torch.Tensor, W: int, R: int):
    if not supported(W, R):
        raise ValueError(f"strict kernel does not take W={W}, R={R}; use "
                         "the host encoder")
    gh, gw = img_bits.shape
    if gh % W or gw % W or enb.shape != (W * W + 1,):
        raise ValueError("strict kernel takes a [ny*W, nx*W] tile grid and "
                         "an enb LUT of M+1 entries")


def ring_rows(W: int) -> int:
    """Words per ring column in the serial pass: the band's 2W rows and 9
    of slack for grid 1's last run, odd against bank conflicts (Geo::RR)."""
    return 2 * W + 9


def _plan(W: int, R: int, gh: int, gw: int) -> dict:
    """Launch geometry of csrc/strict_analyze.cu for a [gh, gw] tile grid.

    Grid 2: a tile row's grid-2 window rows (at most min(R, gh-W) - W + 1)
    are cut into ``slices`` blocks per tile of ``slice_rows`` rows each, a
    multiple of RUN2, enough blocks per row to fill the card twice over.
    Serial pass: the live band (rows [i0-W, i0+W)) as a ring of
    ``ring_cols`` columns of ``ring_rows`` words beside the enb LUT, where
    that fits in a block's shared memory (``ring``); else the band stays in
    global memory."""
    nx = gw // W
    rows2 = max(0, min(R, gh - W) - W + 1)
    nrun = -(-rows2 // RUN2)
    slices = min(nrun, -(-G2_BLOCKS // nx))
    rps = -(-nrun // slices) if slices else 0
    slices = -(-nrun // rps) if rps else 0
    cols = min(max(R, W) + 3 * W, gw)
    ring_bytes = cols * ring_rows(W) * 4
    enb_bytes = (W * W + 1) * 4
    ring = enb_bytes + ring_bytes + SMEM_STATIC <= SMEM_MAX
    return dict(slices=slices, slice_rows=rps * RUN2, ring=ring,
                ring_cols=cols if ring else 0, ring_rows=ring_rows(W),
                ring_bytes=ring_bytes if ring else 0,
                smem=enb_bytes + (ring_bytes if ring else 0))


def strict_analyze_plain(img_bits, enb, *, W: int, R: int, T_thresh: int,
                         cols: int):
    """Plain PyTorch K3: a loop over the tiles in raster order.

    img_bits: 0/1 [ny*W, nx*W] padded tile grid; enb: int32 [M+1]
    enumerative code lengths.  The live plane and the Golomb contexts stay
    in tensors, so nothing waits on the device inside the loop."""
    _check(img_bits, enb, W, R)
    lay = _layout(W, R)
    gh, gw = img_bits.shape
    ny, nx = gh // W, gw // W
    dev = img_bits.device
    M, wmask = W * W, (1 << W) - 1
    _, mcost, ncost = mode_costs(8)
    lut = enb.to(torch.int64)
    E = _field_plane(img_bits[None], W, gh, gw)[0]          # live, int64
    ar = torch.arange(W, device=dev)
    win = 2 * R + 1
    j0s = torch.arange(nx, device=dev) * W
    xs = j0s[:, None] - R + torch.arange(win, device=dev)        # [nx, win]
    ks = torch.arange(32, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    # Golomb contexts, rows match / nomatch, columns (acc, n, k)
    g = torch.tensor([[0, 0, 1], [0, 0, 1]], dtype=torch.int64, device=dev)
    out = torch.empty((ny * nx, 8), dtype=torch.int64, device=dev)
    resf = torch.empty((ny * nx, W), dtype=torch.int64, device=dev)
    kw = dict(W=W, R=R, cols=cols, lay=lay)
    pk = dict(M=M, T_thresh=T_thresh, invert=True, lay=lay)
    for ti in range(ny):
        i0 = ti * W
        i0t = zero + i0
        # grid 2 of the whole row: rows <= i0-W are final
        lo2 = max(i0 - R, 0)
        p2 = torch.full((nx,), INF, dtype=torch.int64, device=dev)
        if i0 - W >= lo2:
            Ep = torch.nn.functional.pad(E, (R, R))
            y2 = torch.arange(lo2, i0 - W + 1, device=dev)
            d2 = torch.zeros((len(y2), nx, win), dtype=torch.int64,
                             device=dev)
            for a in range(W):
                d2 += popcount(Ep[y2 + a][:, xs + R] ^ E[i0 + a, j0s, None])
            key, valid = _packed_window_keys(i0t, j0s[:, None],
                                             y2[:, None, None], xs[None],
                                             grids=(2,), **kw)
            p2 = _packed_priority(d2, key, valid, **pk).amin(dim=(0, 2))
        y1 = torch.arange(max(i0 - W, 0), i0 + 1, device=dev)
        for tj in range(nx):
            j0 = tj * W
            t = ti * nx + tj
            p = E[i0 + ar, j0]                                   # [W]
            pr = p2[tj]
            if j0 - W >= max(j0 - R, 0):          # grid 1 has columns
                x1 = torch.arange(max(j0 - R, 0), j0 - W + 1, device=dev)
                d1 = popcount(E[(y1[:, None] + ar)[..., None], x1]
                              ^ p[:, None]).sum(dim=1)           # [ny1, nx1]
                key, valid = _packed_window_keys(i0t, zero + j0,
                                                 y1[:, None], x1[None],
                                                 grids=(1,), **kw)
                pr = torch.minimum(pr, _packed_priority(d1, key, valid,
                                                        **pk).amin())
            sel = _packed_decode(pr, i0t, zero + j0, zero, **kw)
            bestd, y, inv, _, rank, n_cands, has_cands, x = sel
            # the finish, in the field domain
            pc = E[y + ar, x]
            p3 = (torch.where(inv != 0, p ^ wmask, p) ^ pc) & wmask
            res4 = torch.stack([p3, med_fields(p3, wmask), p,
                                med_fields(p, wmask)])           # [4, W]
            w4 = popcount(res4).sum(dim=1)
            il = idx_len(n_cands)
            # the mode decision (K2's costs, codec 8)
            k = g[[0, 0, 1, 1], 2]
            c = k + (w4 >> k) + 1 + lut[w4]
            c = c + torch.stack([mcost + il, mcost + il, zero + ncost,
                                 zero + ncost])
            c[:2] = torch.where(has_cands != 0, c[:2], BIG)
            mode = torch.argmin(c)                # first minimum on ties
            weight = w4[mode]
            ctx = (mode >= 2).to(torch.int64)
            k_used = k[mode]
            n2 = (g[ctx, 1] + 1) & U32
            acc2 = (g[ctx, 0] + weight) & U32
            k2 = torch.where(((n2 << ks) & U32) >= acc2, ks, 31).amin()
            g[ctx] = torch.stack([acc2, n2, k2])
            res = res4[mode]
            # substitution: fields x in [j0-W+1, j0+W) of rows [i0, i0+W)
            xr = torch.arange(max(j0 - W + 1, 0), min(j0 + W, gw),
                              device=dev)
            s = xr - j0
            lsh, rsh = torch.clamp(s, min=0), torch.clamp(-s, min=0)
            put = torch.where(s <= 0, res[:, None] >> rsh,
                              (res[:, None] << lsh) & wmask)
            wm = zero + wmask
            keep = torch.where(s <= 0, wm >> rsh, (wm << lsh) & wmask)
            rows_ = slice(i0, i0 + W)
            E[rows_, xr] = (E[rows_, xr] & ~keep) | put
            out[t] = torch.stack([mode, rank, inv, weight, k_used, n_cands,
                                  il, bestd])
            resf[t] = res
    return out.to(torch.int32), to_i32(resf)


def strict_analyze(img_bits, enb, *, W: int, R: int, T_thresh: int,
                   cols: int):
    """K3 on one page: (out int32 [T, 8], residual fields int32 [T, W]).

    img_bits: 0/1 [ny*W, nx*W] padded tile grid; enb: int32 [M+1]
    (``compress.enb_lut``) on the same device."""
    kw = dict(W=W, R=R, T_thresh=T_thresh, cols=cols)
    if img_bits.is_cuda:
        return _launch(img_bits, enb, **kw)
    if img_bits.device.type == "cpu":
        return strict_analyze_plain(img_bits, enb, **kw)
    raise RuntimeError(f"K3 has no kernel for device {img_bits.device}")


def _launch(img_bits, enb, *, W, R, T_thresh, cols):
    """Launch csrc/strict_analyze.cu: the field plane, then per tile row
    the grid-2 pass (nx x slices blocks) and the serial pass (one block)."""
    _check(img_bits, enb, W, R)
    if enb.dtype != torch.int32 or not enb.is_contiguous() \
            or enb.device != img_bits.device:
        raise ValueError("K3: enb must be contiguous int32 on the page's "
                         "device")
    lay = _layout(W, R)
    gh, gw = img_bits.shape
    plan = _plan(W, R, gh, gw)
    dev = img_bits.device
    T = (gh // W) * (gw // W)
    img = img_bits.to(torch.uint8).contiguous()      # 0/1 bytes
    E = torch.empty((gh, gw), dtype=torch.int32, device=dev)  # field plane
    pr2 = torch.full((gw // W,), INF, dtype=torch.int64, device=dev)
    # Golomb contexts (acc, n, k) x (match, nomatch), k from 1; filled on
    # the device, so the call does not wait for the stream
    gctx = torch.zeros(6, dtype=torch.int32, device=dev)
    gctx[2::3] = 1
    out = torch.empty((T, 8), dtype=torch.int32, device=dev)
    resf = torch.empty((T, W), dtype=torch.int32, device=dev)
    lib = _cuda.get_lib()
    p = ctypes.c_void_p
    _cuda.check(lib.bic_strict_analyze(
        p(img.data_ptr()), p(E.data_ptr()), p(pr2.data_ptr()),
        p(enb.data_ptr()),
        p(gctx.data_ptr()), p(out.data_ptr()), p(resf.data_ptr()), gh, gw,
        W, R, T_thresh, cols, lay["span"], lay["off1"], lay["kb"], lay["db"],
        plan["ring_cols"], plan["ring_rows"], plan["slices"],
        plan["slice_rows"], _cuda.stream(dev)), "bic_strict_analyze")
    _cuda.launches["strict_analyze"] += 1
    return out, resf
