"""Plain K1 (ops/fused_search) against the JAX package's fused Pallas kernel
(interpret mode on the CPU): all 8 selection outputs and the field plane E,
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.ops import pallas_kernels as pk
from binary_image_compression_tpu.ops import search as jsearch
from binary_image_compression_tpu_torch.ops import fused_search as fs


def _page(rows, cols, density, seed, bottom):
    img = np.random.RandomState(seed).rand(rows, cols) < density
    if bottom:
        # ink only in the last rows: the bottom tiles' grid-1 candidates
        # reach into the zero-padded rows of the tile grid and the plane
        img[: rows - rows // 4] = False
    return img


CASES = [
    # rows, cols, W, R, T_thresh, invert, density, y_base, bottom
    (64, 64, 8, 16, 1, True, 0.3, 0, False),
    (64, 96, 8, 32, 2, True, 0.2, 0, False),
    (64, 64, 16, 32, 1, True, 0.3, 16, False),     # absolute rows (y_base)
    (96, 96, 16, 64, 0, True, 0.1, 0, False),
    (96, 96, 32, 32, 3, True, 0.3, 0, False),
    (96, 128, 32, 192, 2, True, 0.2, 0, False),    # JAX masked-grid path
    (75, 101, 8, 24, 1, True, 0.35, 0, False),     # ragged
    (70, 90, 16, 32, 300, False, 0.4, 0, False),   # invert off, all stop
    (45, 72, 8, 64, 1, True, 0.3, 0, True),        # bottom-edge heavy
]


@pytest.mark.parametrize("case", CASES, ids=[
    "W8R16", "W8R32", "W16R32-ybase", "W16R64", "W32R32", "W32R192",
    "ragged", "no-invert", "bottom-edge"])
def test_plain_k1_matches_jax_fused_kernel(case):
    rows, cols, W, R, T_thresh, invert, density, y_base, bottom = case
    img = _page(rows, cols, density, rows * cols + W + R, bottom)
    ny, nx = -(-rows // W), -(-cols // W)
    grid = np.zeros((ny * W, nx * W), dtype=np.int8)
    grid[:rows, :cols] = img
    i0, j0, _, _ = jsearch.tile_origins(rows, cols, W)
    jsel, joy, _, jE = pk.fused_search_select(
        jnp.asarray(grid), i0, j0, ny, nx, W=W, R=R, T_thresh=T_thresh,
        rows=rows, cols=cols, invert=invert,
        y_base=jnp.int32(y_base) if y_base else None, with_plane=True)

    sel, oy, E = fs.fused_search_select(
        torch.from_numpy(grid[None].astype(bool)), ny, nx, W=W, R=R,
        T_thresh=T_thresh, cols=cols, invert=invert, y_base=y_base)
    assert sel.dtype == torch.int32 and sel.shape == (1, ny * nx, 8)
    np.testing.assert_array_equal(E[0].numpy().view(np.uint32),
                                  np.asarray(jE))
    np.testing.assert_array_equal(oy.numpy(), np.asarray(joy))
    jnames = dict(inv="bestinv")
    for c, name in enumerate(fs.OUT_FIELDS):
        want = np.asarray(jsel[jnames.get(name, name)]).astype(np.int64)
        np.testing.assert_array_equal(sel[0, :, c].numpy(), want,
                                      err_msg=name)
    assert sel[0, :, 3].sum() > 0


def test_layout_is_64_bit_where_jax_needs_the_grid_path():
    """The port's 64-bit priority fits every shape the fused path takes,
    including those where the JAX package's 32-bit layout does not."""
    assert pk.packed_sel_layout(32, 192, 128) is None
    assert fs.packed_sel_layout(32, 192) is not None
    for W, R in ((8, 16), (16, 128), (32, 32), (32, 1000)):
        lay = fs.packed_sel_layout(W, R)
        assert lay["db"] + lay["kb"] + 3 <= 62
        jl = pk.packed_sel_layout(W, R, 512)
        if jl is not None:
            assert {k: lay[k] for k in jl} == jl
    assert fs.packed_sel_layout(16, 8) is None


@pytest.mark.parametrize("shape", [(32, 32, 16, 128), (128, 128, 16, 128),
                                   (8, 8, 16, 8), (4, 4, 40, 64),
                                   (16, 600, 8, 512), (10, 10, 12, 24)])
def test_fused_supported_routes_like_jax(shape):
    assert fs.fused_supported(*shape) == pk.fused_supported(*shape)


def test_unsupported_shapes_raise_not_implemented():
    img = torch.zeros((1, 80, 80), dtype=torch.bool)
    with pytest.raises(NotImplementedError, match="banded route"):
        fs.fused_search_select(img, 2, 2, W=40, R=64, T_thresh=1, cols=80,
                               invert=True)
