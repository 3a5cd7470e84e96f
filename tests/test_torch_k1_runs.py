"""A numpy model of K1's order of work (csrc/fused_search.cu) against the
plain K1 (ops/fused_search.fused_search_select_plain): per (column x, run
of L window rows) the winner by run_best's 32-bit rule, then the minimum
of the winners' packed priorities over all runs, decoded into the 8
outputs.  Equal outputs show, without a card, that a column's valid window
rows form one interval whose scan key falls strictly as y grows, so a run
needs only its winner's 64-bit priority."""

import numpy as np
import pytest
import torch

from binary_image_compression_tpu_torch.ops import fused_search as fs

THREADS = 256   # fused_search.cu: kThreads


def _popcount(x):
    """Popcount of uint32 values (SWAR), int64."""
    x = x.astype(np.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _page(rows, cols, density, seed, bottom):
    img = np.random.RandomState(seed).rand(rows, cols) < density
    if bottom:
        img[: rows - rows // 4] = False
    return img


def _items(ncol, n, tid):
    """The (run q, column c) items thread `tid` visits: the kernel's
    division-free stepping of idx = q * ncol + c by THREADS."""
    dq, dc = THREADS // ncol, THREADS - (THREADS // ncol) * ncol
    q, c = tid // ncol, tid % ncol
    out = []
    for _ in range(tid, n, THREADS):
        out.append((q, c))
        q, c = q + dq, c + dc
        if c >= ncol:
            c, q = c - ncol, q + 1
    return out


def k1_runs_model(E, ny, nx, *, W, R, T_thresh, cols, invert, y_base, L):
    """E uint32 [B, He, We] -> the packed minimum per tile, int64 [B, T],
    reduced as the kernel reduces: run winners first."""
    lay = fs.packed_sel_layout(W, R)
    span, off1, kb, db = lay["span"], lay["off1"], lay["kb"], lay["db"]
    B, He, We = E.shape
    M = W * W
    best = np.full((B, ny * nx), fs.INF, dtype=np.int64)
    for b in range(B):
        for t in range(ny * nx):
            i0, j0 = (t // nx) * W, (t % nx) * W
            oy = min(max(i0 - R, 0), max(He - W - R, 0))
            i0a, oya = i0 + y_base, oy + y_base
            minj, maxj = max(j0 - R, 0), min(j0 + R, cols - W)
            ya, yhi = max(max(i0a - R, 0), oya), min(i0a, oya + R)
            ncol = maxj - minj + 1
            if ncol <= 0 or yhi < ya:
                continue
            nrun = (yhi - ya + L) // L
            ys = ya + np.arange(nrun * L)                  # absolute rows
            xs = minj + np.arange(ncol)
            d = np.zeros((nrun * L, ncol), dtype=np.int64)
            for a in range(W):                   # frame rows, clamped
                rows_ = np.minimum(ys - y_base + a, He - 1)
                d += _popcount(E[b, rows_][:, xs] ^ E[b, i0 + a, j0])
            g1 = (j0 >= W) & (xs <= j0 - W)
            ylast = np.minimum(np.where(g1, i0a, i0a - W), oya + R)
            dp = np.minimum(d, M - d) if invert else d
            v = np.where(ys[:, None] <= ylast[None], np.where(
                dp <= T_thresh, -1, dp), np.iinfo(np.int64).max)
            # run_best: least v, ties to the largest y (scan l downwards)
            vr = v.reshape(nrun, L, ncol)[:, ::-1]
            lw = L - 1 - vr.argmin(axis=1)                   # [nrun, ncol]
            has = vr.min(axis=1) < np.iinfo(np.int64).max
            q = np.arange(nrun)[:, None]
            yw = ya + q * L + lw
            dw = d.reshape(nrun, L, ncol)[q, lw, np.arange(ncol)[None]]
            x = xs[None]
            key = np.where(g1[None] & (yw >= i0a - W),
                           (i0a - yw) * span + (j0 - W - x),
                           off1 + (i0a - W - yw) * span + (maxj - x))
            dpw = np.minimum(dw, M - dw) if invert else dw
            inv = ((M - dw) < dw).astype(np.int64) if invert else 0 * dw
            pr = np.where(dpw <= T_thresh,
                          (key << (db + 1)) | (dpw << 1) | inv,
                          lay["flag"] | (dpw << (kb + 1)) | (key << 1) | inv)
            best[b, t] = np.where(has, pr, fs.INF).min()
    return best


CASES = [
    # the cases of test_torch_fused_search.py, then W = 5 and 12 (the
    # run-time-W instance) and a negative y_base
    # rows, cols, W, R, T_thresh, invert, density, y_base, bottom
    (64, 64, 8, 16, 1, True, 0.3, 0, False),
    (64, 96, 8, 32, 2, True, 0.2, 0, False),
    (64, 64, 16, 32, 1, True, 0.3, 16, False),
    (96, 96, 16, 64, 0, True, 0.1, 0, False),
    (96, 96, 32, 32, 3, True, 0.3, 0, False),
    (96, 128, 32, 192, 2, True, 0.2, 0, False),
    (75, 101, 8, 24, 1, True, 0.35, 0, False),
    (70, 90, 16, 32, 300, False, 0.4, 0, False),
    (45, 72, 8, 64, 1, True, 0.3, 0, True),
    (40, 53, 5, 10, 1, True, 0.3, 0, False),
    (60, 84, 12, 24, 2, True, 0.3, 0, False),
    (64, 80, 16, 48, 1, True, 0.3, -24, False),
]
IDS = ["W8R16", "W8R32", "W16R32-ybase", "W16R64", "W32R32", "W32R192",
       "ragged", "no-invert", "bottom-edge", "W5R10", "W12R24",
       "W16R48-negative-ybase"]


@pytest.mark.parametrize("L", [1, 6, 8, 12])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_run_reduction_matches_plain_k1(case, L):
    rows, cols, W, R, T_thresh, invert, density, y_base, bottom = case
    img = _page(rows, cols, density, rows * cols + W + R, bottom)
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((1, ny * W, nx * W), dtype=bool)
    grid[0, :rows, :cols] = img
    He = fs.plane_height(ny * W, W, R)
    E = fs.to_i32(fs._field_plane(torch.from_numpy(grid), W, He, nx * W))
    kw = dict(W=W, R=R, T_thresh=T_thresh, cols=cols, invert=invert,
              y_base=y_base)
    want = fs.fused_search_select_plain(E, ny, nx, **kw)
    pr = k1_runs_model(E.numpy().view(np.uint32), ny, nx, L=L, **kw)
    i0 = torch.arange(ny).repeat_interleave(nx) * W
    j0 = torch.arange(nx).repeat(ny) * W
    oy = fs.band_origins(ny, W, R, He).repeat_interleave(nx)
    got = fs._packed_decode(torch.from_numpy(pr), i0 + y_base, j0,
                            oy + y_base, W=W, R=R, cols=cols,
                            lay=fs.packed_sel_layout(W, R))
    assert torch.equal(got.to(torch.int32), want)
    assert int(want[..., 3].sum()) > 0


@pytest.mark.parametrize("ncol", [1, 7, 129, 255, 256, 257, 513])
def test_item_stepping_visits_every_item_once(ncol):
    n = 17 * ncol
    items = [it for tid in range(THREADS) for it in _items(ncol, n, tid)]
    assert sorted(items) == [(q, c) for q in range(17) for c in range(ncol)]
