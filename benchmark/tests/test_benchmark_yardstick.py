"""The frozen yardstick under reference/roofline equals the program's own
counting functions (utils/roofline) on the cells' shapes."""

import pytest

from binary_image_compression_tpu_torch.utils import roofline as port
from reference import roofline as frozen

SHAPES = {"fax": (2376, 1728), "letter": (3300, 2550), "check": (550, 1200),
          "doc512": (512, 512)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_search_counts_match(shape):
    rows, cols = SHAPES[shape]
    assert frozen.search_candidates(rows, cols, 16, 128) == \
        port.search_candidates(rows, cols, 16, 128)
    assert frozen.search_popcounts(rows, cols, 16, 128) == \
        port.search_popcounts(rows, cols, 16, 128)
    assert frozen.window_popcounts(16) == port.window_popcounts(16)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_k1_bytes_and_plane_match(shape):
    from binary_image_compression_tpu_torch.ops import fused_search
    rows, cols = SHAPES[shape]
    gh, gw = -(-rows // 16) * 16, -(-cols // 16) * 16
    He = frozen.k1_plane_height(gh, 16, 128)
    assert He == fused_search.plane_height(gh, 16, 128)
    T = (gh // 16) * (gw // 16)
    assert frozen.k1_bytes(32, He, gw, T) == port.k1_bytes(32, He, gw, T)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_rans_work_matches(shape):
    rows, cols = SHAPES[shape]
    S = max(1, min(16, rows // 128))
    sr = -(-rows // S)
    steps = -(-(sr * cols) // 32)
    for out in (None, 123_457):
        assert frozen.rans_work(rows * cols, steps, S, 32, out) == \
            port.rans_work(rows * cols, steps, S, 32, out)


def test_rates_and_bound_match():
    assert frozen.H100_POPC_PER_S == port.H100_POPC_PER_S
    assert frozen.H100_HBM_BYTES_PER_S == port.H100_HBM_BYTES_PER_S
    for kw in ({"popcounts": 10 ** 9}, {"nbytes": 10 ** 9},
               {"popcounts": 10 ** 8, "nbytes": 10 ** 10}):
        assert frozen.bound_ms(**kw) == port.bound_ms(**kw)
