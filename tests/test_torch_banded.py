"""The banded fallback search in the port on the CPU: the distance maps
of K4's plain version (from the field plane) against the JAX package's
``search.window_distance_maps_banded`` on every in-window cell, its
selection over maps against the JAX package's ``select_windows`` Pallas
kernel (interpret mode) on the same maps, and ``compress.encode`` at W in
{40, 64} against the JAX device path and the host encoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu.models import compress as jcompress
from binary_image_compression_tpu.ops import pallas_kernels as pk
from binary_image_compression_tpu.ops import search as jsearch
from binary_image_compression_tpu_torch.models import codec, compress
from binary_image_compression_tpu_torch.ops import fused_search as fs
from binary_image_compression_tpu_torch.ops import search
from binary_image_compression_tpu_torch.ops import select_windows as sw

CASES = [
    # rows, cols, W, R, T_thresh, density
    (80, 96, 40, 48, 1, 0.3),
    (64, 72, 16, 24, 2, 0.2),      # a band K1 would take, on the fallback
    (70, 90, 33, 40, 300, 0.4),    # ragged, every candidate stops the scan
    (128, 128, 64, 64, 1, 0.3),
]


def _maps(rows, cols, W, R, density, seed):
    img = np.random.RandomState(seed).rand(rows, cols) < density
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((ny * W, nx * W), dtype=np.int8)
    grid[:rows, :cols] = img
    i0, j0, _, _ = jsearch.tile_origins(rows, cols, W)
    jd, joy, jox = jax.device_get(jsearch.window_distance_maps_banded(
        jnp.asarray(grid), i0, j0, W, R, ny, nx))
    E = fs._field_plane(torch.from_numpy(grid[None] != 0), W,
                        fs.plane_height(ny * W, W, R), nx * W)
    d, oy, ox = search.window_distance_maps_banded(E, ny, nx, W, R)
    return grid, (np.asarray(i0), np.asarray(j0)), (jd, joy, jox), (d, oy, ox)


def _in_window(i0, j0, oy, ox, shape, W, R, cols):
    T, h, w = shape
    lay = fs.packed_sel_layout(W, R)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.int64))
    y = t(oy)[:, None, None] + torch.arange(h)[None, :, None]
    x = t(ox)[:, None, None] + torch.arange(w)[None, None, :]
    _, valid = fs._packed_window_keys(t(i0)[:, None, None],
                                      t(j0)[:, None, None], y, x, W=W, R=R,
                                      cols=cols, lay=lay)
    return valid.numpy()


@pytest.mark.parametrize("case", CASES, ids=["W40", "W16", "W33-ragged",
                                             "W64"])
def test_banded_maps_match_jax_in_window(case):
    rows, cols, W, R, _, density = case
    _, (i0, j0), (jd, joy, jox), (d, oy, ox) = _maps(rows, cols, W, R,
                                                     density, W + R)
    assert d.dtype == torch.int32 and d.shape[1:] == jd.shape
    np.testing.assert_array_equal(oy.numpy(), joy)
    np.testing.assert_array_equal(ox.numpy(), jox)
    valid = _in_window(i0, j0, joy, jox, jd.shape, W, R, cols)
    assert valid.sum() > 0
    np.testing.assert_array_equal(d[0].numpy()[valid], np.asarray(jd)[valid])


@pytest.mark.parametrize("case", CASES, ids=["W40", "W16", "W33-ragged",
                                             "W64"])
def test_plain_k4_matches_jax_select_windows(case):
    rows, cols, W, R, T_thresh, density = case
    grid, (i0, j0), (jd, joy, jox), (d, oy, ox) = _maps(rows, cols, W, R,
                                                        density, W + R)
    # the same maps on both sides (the port's; they agree in-window above)
    want = jax.device_get(pk.select_windows(
        jnp.asarray(d[0].numpy()), i0, j0, joy, jox, W=W, R=R,
        T_thresh=T_thresh, rows=rows, cols=cols, invert=True,
        interpret=True))
    nx = grid.shape[1] // W
    sel = sw.select_maps(d, oy, ox, nx, W=W, R=R, T_thresh=T_thresh,
                         cols=cols, invert=True)
    assert sel.dtype == torch.int32 and sel.shape == (1, len(i0), 8)
    # JAX returns x relative to the map origin ox; the port, as K1, absolute
    want["dx"] = np.asarray(want["dx"]) + jox
    jnames = dict(inv="bestinv")
    for c, name in enumerate(fs.OUT_FIELDS):
        np.testing.assert_array_equal(
            sel[0, :, c].numpy(),
            np.asarray(want[jnames.get(name, name)]).astype(np.int64),
            err_msg=name)
    assert sel[0, :, 3].sum() > 0


@pytest.mark.parametrize("rows,cols,W,R", [(96, 128, 40, 64),
                                           (128, 128, 64, 64),
                                           (75, 101, 48, 56)])
def test_encode_wide_tiles_matches_jax_and_host(rows, cols, W, R):
    img = np.random.RandomState(rows + W).rand(rows, cols) < 0.3
    img[rows // 2:, cols // 2:] = img[:rows - rows // 2, :cols - cols // 2]
    p = codec.CodecParams(codec=8, W=W, R=R, strict=False)
    jp = jcodec.CodecParams(codec=8, W=W, R=R, strict=False)
    assert not fs.fused_supported(-(-rows // W), -(-cols // W), W, R)
    blob = compress.encode(img, p, device="cpu")
    assert blob == jcodec.encode(img, jp)
    assert blob == jcompress.encode(img, jp)
    np.testing.assert_array_equal(codec.decode(blob), img)


def test_wide_band_takes_the_fallback_like_jax():
    """W = 8 on a strip wider than K1's band budget: both packages leave the
    fused search; the port's banded route gives the host encoder's
    stream."""
    img = np.random.RandomState(9).rand(16, 105_000) < 0.2
    img[:, 52_500:] = img[:, :52_500]
    p = codec.CodecParams(codec=8, W=8, R=8, strict=False)
    jp = jcodec.CodecParams(codec=8, W=8, R=8, strict=False)
    assert not fs.fused_supported(2, 13_125, 8, 8)
    assert not pk.fused_supported(2, 13_125, 8, 8)
    assert compress.encode(img, p, device="cpu") == jcodec.encode(img, jp)


def test_encode_analyze_banded_batch_matches_single_pages():
    pages = np.random.RandomState(2).rand(3, 80, 80) < 0.3
    p = codec.CodecParams(codec=8, W=40, R=40, strict=False)
    blobs = compress.encode_batch(pages, p, device="cpu")
    for i in range(3):
        assert blobs[i] == compress.encode(pages[i], p, device="cpu")
