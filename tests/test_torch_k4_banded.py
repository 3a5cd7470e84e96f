"""K4, the banded search and selection, on the CPU.

The plain K4 (``select_windows.select_windows`` on CPU tensors: the 64-bit
field plane, the banded maps from it and the selection) against the JAX
package's banded route (``search.window_distance_maps_banded`` and the
``select_windows`` Pallas kernel in interpret mode), exactly.  Then numpy
models of the CUDA kernels' order of work (csrc/select_windows.cu), held
against the plain version: per (column x, run of L window rows) the
winner by run_best's 32-bit rule and the minimum of the winners' packed
priorities, decoded into the 8 outputs; the ring of L candidate rows that
``window_dists64`` keeps; the items of a tile spread over slices of
blocks; and the plane kernel's three-ballot bit arithmetic.  Equal outputs
show, without a card, that a column's valid window rows form one interval
whose scan key falls strictly as y grows, at W > 32 as at W <= 32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.ops import pallas_kernels as pk
from binary_image_compression_tpu.ops import search as jsearch
from binary_image_compression_tpu_torch.ops import fused_search as fs
from binary_image_compression_tpu_torch.ops import search
from binary_image_compression_tpu_torch.ops import select_windows as sw

THREADS = 256   # select_windows.cu: kThreads
MASK64 = (1 << 64) - 1

CASES = [
    # rows, cols, W, R, T_thresh, density, B: test_torch_banded.py's cases,
    # then W = 48 and a batch
    (80, 96, 40, 48, 1, 0.3, 1),
    (64, 72, 16, 24, 2, 0.2, 1),
    (70, 90, 33, 40, 300, 0.4, 1),   # ragged, every candidate stops the scan
    (128, 128, 64, 64, 1, 0.3, 1),
    (100, 150, 48, 56, 1, 0.3, 1),
    (96, 130, 64, 96, 2, 0.25, 3),
]
IDS = ["W40", "W16", "W33-ragged", "W64", "W48-ragged", "W64-batch3"]


def _pages(rows, cols, W, density, B, seed):
    img = np.random.RandomState(seed).rand(B, rows, cols) < density
    # repeat a quarter so that some windows match closely
    img[:, rows // 2:, cols // 2:] = img[:, :rows - rows // 2,
                                         :cols - cols // 2]
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((B, ny * W, nx * W), dtype=bool)
    grid[:, :rows, :cols] = img
    return grid, ny, nx


def _jax_banded(page, rows, cols, W, R, T_thresh):
    """The JAX package's banded route on one page: maps + Pallas select."""
    ny, nx = page.shape[0] // W, page.shape[1] // W
    i0, j0, _, _ = jsearch.tile_origins(rows, cols, W)
    d, oy, ox = jsearch.window_distance_maps_banded(
        jnp.asarray(page.astype(np.int8)), i0, j0, W, R, ny, nx)
    want = jax.device_get(pk.select_windows(
        d, i0, j0, oy, ox, W=W, R=R, T_thresh=T_thresh, rows=rows,
        cols=cols, invert=True, interpret=True))
    want["dx"] = np.asarray(want["dx"]) + np.asarray(ox)   # absolute x
    names = dict(inv="bestinv")
    return np.stack([np.asarray(want[names.get(n, n)]).astype(np.int64)
                     for n in fs.OUT_FIELDS], axis=-1), np.asarray(oy)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_k4_matches_jax_banded_route(case):
    rows, cols, W, R, T_thresh, density, B = case
    grid, ny, nx = _pages(rows, cols, W, density, B, rows + W + R)
    sel, oy, E = sw.select_windows(torch.from_numpy(grid), ny, nx, W=W, R=R,
                                   T_thresh=T_thresh, cols=cols, invert=True)
    assert sel.dtype == torch.int32 and sel.shape == (B, ny * nx, 8)
    assert E.dtype == torch.int64
    assert E.shape == (B, fs.plane_height(ny * W, W, R), nx * W)
    for b in range(B):
        want, joy = _jax_banded(grid[b], rows, cols, W, R, T_thresh)
        np.testing.assert_array_equal(oy.numpy(), joy)
        np.testing.assert_array_equal(sel[b].numpy(), want)
    assert int(sel[..., 3].sum()) > 0


def _popcount64(x):
    """Popcount of uint64 values (SWAR), int64."""
    x = x.astype(np.uint64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = (x & np.uint64(0x3333333333333333)) + (
        (x >> np.uint64(2)) & np.uint64(0x3333333333333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(
        np.int64)


def k4_runs_model(E, ny, nx, *, W, R, T_thresh, cols, invert, L):
    """E uint64 [B, He, We] -> the packed minimum per tile, int64 [B, T],
    reduced as the kernel reduces: run winners first.  Asserts that the
    scan key falls strictly with y over each column's valid rows."""
    lay = fs.packed_sel_layout(W, R)
    span, off1, kb, db = lay["span"], lay["off1"], lay["kb"], lay["db"]
    B, He, We = E.shape
    M = W * W
    best = np.full((B, ny * nx), fs.INF, dtype=np.int64)
    for b in range(B):
        for t in range(ny * nx):
            i0, j0 = (t // nx) * W, (t % nx) * W
            oy = min(max(i0 - R, 0), max(He - W - R, 0))
            minj, maxj = max(j0 - R, 0), min(j0 + R, cols - W)
            ya, yhi = max(max(i0 - R, 0), oy), min(i0, oy + R)
            ncol = maxj - minj + 1
            if ncol <= 0 or yhi < ya:
                continue
            nrun = (yhi - ya + L) // L
            ys = ya + np.arange(nrun * L)
            xs = minj + np.arange(ncol)
            d = np.zeros((nrun * L, ncol), dtype=np.int64)
            for a in range(W):                           # rows clamped
                rows_ = np.minimum(ys + a, He - 1)
                d += _popcount64(E[b, rows_][:, xs] ^ E[b, i0 + a, j0])
            g1 = (j0 >= W) & (xs <= j0 - W)
            ylast = np.minimum(np.where(g1, i0, i0 - W), oy + R)
            keys = np.where(g1[None] & (ys[:, None] >= i0 - W),
                            (i0 - ys[:, None]) * span + (j0 - W - xs[None]),
                            off1 + (i0 - W - ys[:, None]) * span
                            + (maxj - xs[None]))
            for c in range(ncol):
                k = keys[ys <= ylast[c], c]
                assert np.all(np.diff(k) < 0)
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
            key = keys.reshape(nrun, L, ncol)[q, lw, np.arange(ncol)[None]]
            dpw = np.minimum(dw, M - dw) if invert else dw
            inv = ((M - dw) < dw).astype(np.int64) if invert else 0 * dw
            pr = np.where(dpw <= T_thresh,
                          (key << (db + 1)) | (dpw << 1) | inv,
                          lay["flag"] | (dpw << (kb + 1)) | (key << 1) | inv)
            assert np.all(yw[has] <= ylast[None].repeat(nrun, 0)[has])
            best[b, t] = np.where(has, pr, fs.INF).min()
    return best


MODEL_CASES = [
    # rows, cols, W, R, T_thresh, invert, density, B
    (80, 96, 40, 48, 1, True, 0.3, 1),
    (128, 128, 64, 64, 1, True, 0.3, 1),
    (130, 150, 64, 128, 2, True, 0.25, 1),   # R > rows: zero plane rows
    (70, 90, 33, 40, 300, True, 0.4, 1),
    (100, 150, 48, 56, 1, False, 0.3, 2),
    (16, 400, 8, 8, 1, True, 0.2, 1),        # a W = 8 strip
]
MODEL_IDS = ["W40", "W64", "W64-tall-band", "W33-stop", "W48-no-invert-x2",
             "W8-strip"]


@pytest.mark.parametrize("L", [4, 6, 8, 12])
@pytest.mark.parametrize("case", MODEL_CASES, ids=MODEL_IDS)
def test_run_reduction_matches_plain_k4(case, L):
    rows, cols, W, R, T_thresh, invert, density, B = case
    grid, ny, nx = _pages(rows, cols, W, density, B, rows * cols + W + R)
    kw = dict(W=W, R=R, T_thresh=T_thresh, cols=cols, invert=invert)
    want, oy, E = sw.select_windows(torch.from_numpy(grid), ny, nx, **kw)
    pr = k4_runs_model(E.numpy().view(np.uint64), ny, nx, L=L, **kw)
    i0 = torch.arange(ny).repeat_interleave(nx) * W
    j0 = torch.arange(nx).repeat(ny) * W
    got = fs._packed_decode(torch.from_numpy(pr), i0, j0, oy, W=W, R=R,
                            cols=cols, lay=fs.packed_sel_layout(W, R))
    assert torch.equal(got.to(torch.int32), want)
    assert int(want[..., 3].sum()) > 0


def ring_dists(col, tf, W, L):
    """window_dists64 step by step: tile row a against the ring of
    candidate rows a .. a+L-1 (row r in slot r % L), one load per step."""
    d = [0] * L
    f = [col[r] for r in range(L)]
    loads = L
    for a0 in range(0, W, L):
        for s in range(L):
            a = a0 + s
            if a < W:
                t = tf[a]
                for l in range(L):
                    d[l] += bin(f[(s + l) % L] ^ t).count("1")
                if a + 1 < W:
                    f[s] = col[a + L]
                    loads += 1
    return d, loads


@pytest.mark.parametrize("L", [4, 6, 8, 12])
@pytest.mark.parametrize("W", [5, 8, 33, 48, 64])
def test_ring_of_candidate_rows_gives_every_window(W, L):
    rs = np.random.RandomState(W * L)
    wm = (1 << W) - 1
    col = [int(v) & wm for v in rs.randint(0, 2 ** 62, size=L + W - 1)]
    tf = [int(v) & wm for v in rs.randint(0, 2 ** 62, size=W)]
    d, loads = ring_dists(col, tf, W, L)
    want = [sum(bin(col[l + a] ^ tf[a]).count("1") for a in range(W))
            for l in range(L)]
    assert d == want
    assert loads == L + W - 1


def _slice_items(ncol, n, slices):
    """(run q, column c) items of every thread of every slice: thread tid
    of slice s starts at s * THREADS + tid and steps by THREADS * slices
    without a division, as banded_search_kernel does."""
    step = THREADS * slices
    dq, dc = step // ncol, step % ncol
    out = []
    for s in range(slices):
        for tid in range(THREADS):
            first = s * THREADS + tid
            q, c = first // ncol, first % ncol
            for _ in range(first, n, step):
                out.append((q, c))
                q, c = q + dq, c + dc
                if c >= ncol:
                    c, q = c - ncol, q + 1
    return out


@pytest.mark.parametrize("ncol,slices", [(1, 1), (7, 3), (257, 17),
                                         (256, 2), (129, 5), (513, 1)])
def test_slices_visit_every_item_once(ncol, slices):
    n = 17 * ncol
    items = _slice_items(ncol, n, slices)
    assert sorted(items) == [(q, c) for q in range(17) for c in range(ncol)]


def plane_row_model(row, W):
    """banded_plane_kernel on one row of 0/1 pixels: per warp, three ballots
    of pixels x0 .. x0+95; lane k takes bits k .. k+63 and bit-reverses them
    so that pixel x + a lands at bit W-1-a."""
    gw = len(row)
    out = []
    for x0 in range(0, -(-gw // 32) * 32, 32):
        ballot = [sum(1 << k for k in range(32)
                      if x0 + 32 * i + k < gw and row[x0 + 32 * i + k])
                  for i in range(3)]
        lo, hi = ballot[0] | ballot[1] << 32, ballot[2]
        for lane in range(32):
            if x0 + lane >= gw:
                break
            v = lo if lane == 0 else ((lo >> lane) | (hi << (64 - lane))) \
                & MASK64
            rev = int(f"{v:064b}"[::-1], 2)
            out.append(rev >> (64 - W))
    return out


@pytest.mark.parametrize("W", [1, 8, 33, 48, 64])
def test_plane_kernel_bits_match_field_plane(W):
    rs = np.random.RandomState(W)
    img = rs.rand(2, 3, 150) < 0.5
    E = fs._field_plane(torch.from_numpy(img), W, 4, 150).numpy().view(
        np.uint64)
    for b in range(2):
        for y in range(3):
            assert plane_row_model(img[b, y], W) == [int(v) for v in E[b, y]]
        assert not E[b, 3].any()                      # the zero row past gh


def test_banded_origins_are_k1s_band_origins():
    """oy of the banded route == K1's band origin over a plane of
    plane_height rows, which K4's kernels take."""
    for gh, W, R in ((512, 64, 128), (128, 64, 64), (130, 64, 128),
                     (75, 33, 40), (16, 8, 8), (3328, 64, 128)):
        gh = -(-gh // W) * W
        oy, _ = search.banded_origins(gh, 2 * W, W, R)
        He = fs.plane_height(gh, W, R)
        want = fs.band_origins(gh // W, W, R, He).repeat_interleave(2)
        assert torch.equal(oy, want)
        assert He == max(gh, R + W)
