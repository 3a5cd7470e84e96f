"""The port's work counts (``utils/roofline``) and K3's launch plan
(``strict._plan``) on the CPU: the candidate counts against a brute-force
count of the plain selection's own window masks, the doc512 figures, and
the plan's grid-2 slicing and shared-memory ring."""

import os

import pytest
import torch

from binary_image_compression_tpu_torch.ops import decide, fused_search, strict
from binary_image_compression_tpu_torch.utils import pnm, roofline

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _brute_candidates(rows, cols, W, R):
    """Valid windows of grid 1 and of grid 2 over every tile, from the
    masks of ``fused_search._packed_window_keys``."""
    ny, nx = -(-rows // W), -(-cols // W)
    lay = strict._layout(W, R)
    j0 = (torch.arange(nx) * W)[:, None, None]
    x = torch.arange(nx * W + W)[None, None, :]
    counts = []
    for grid in (1, 2):
        n = 0
        for ti in range(ny):
            i0 = torch.tensor(ti * W)
            y = torch.arange(max(ti * W - R - 1, 0), ti * W + 1)[None, :, None]
            _, valid = fused_search._packed_window_keys(
                i0, j0, y, x, W=W, R=R, cols=cols, lay=lay, grids=(grid,))
            n += int(valid.sum())
        counts.append(n)
    return tuple(counts)


@pytest.mark.parametrize("W,R,page", [(8, 16, "text64"),
                                      (8, 24, "ragged75x101"),
                                      (16, 9, "text64"),
                                      (16, 64, "text256"),
                                      (24, 48, "text256"),
                                      (32, 48, "text256")])
def test_search_candidates_match_the_window_masks(W, R, page):
    rows, cols = pnm.read_pbm(os.path.join(FIX, page + ".pbm")).shape
    assert roofline.search_candidates(rows, cols, W, R) == \
        _brute_candidates(rows, cols, W, R)


def test_doc512_figures():
    g1, g2 = roofline.search_candidates(512, 512, 16, 128)
    assert (g1, g2) == (1613040, 21604960)
    assert (g1 + g2) * 16 == 371488000           # one XOR per 16-bit field
    # the windows' 256 bits in 32-bit words: 8 popcounts each
    assert roofline.window_popcounts(16) == 8
    assert roofline.search_popcounts(512, 512, 16, 128) == 185744000
    ms, by = roofline.bound_ms(
        popcounts=185744000, nbytes=roofline.k3_bytes(512, 512, 16))
    assert by == "operations" and ms == pytest.approx(0.0444, abs=1e-4)
    assert roofline.k3_chain_floor_ms(512, 512, 16, 128) == \
        pytest.approx(0.4073, abs=1e-4)


@pytest.mark.parametrize("W,n", [(8, 2), (16, 8), (24, 18), (32, 32),
                                 (5, 1), (40, 50), (64, 128)])
def test_window_popcounts_are_whole_words(W, n):
    assert roofline.window_popcounts(W) == n
    assert (n - 1) * 32 < W * W <= n * 32


def test_rates_are_hoppers():
    assert roofline.H100_POPC_PER_S == 132 * 16 * 1.98e9
    assert roofline.H100_HBM_BYTES_PER_S == 3.35e12
    assert roofline.H100_POPC_PER_S == \
        roofline.H100_SMS * roofline.H100_SM_POPC_PER_S


@pytest.mark.parametrize("N,K,nw", [(1024, 64, 8), (4096, 256, 32),
                                    (1, 1, 1)])
def test_k5_k6_work(N, K, nw):
    pops, nbytes = roofline.k5_work(N, K, nw)
    assert pops == N * K * nw
    assert nbytes == 4 * (N * nw + K * nw + N * K)
    pops6, nbytes6 = roofline.k6_work(N, nw)
    assert (pops6, nbytes6) == (N * nw, 4 * (N * nw + N))
    # a popcount per word moved: well under the H100's ~1.2 popcounts per
    # byte of bandwidth, so both are bound by bytes
    assert roofline.bound_ms(popcounts=pops6, nbytes=nbytes6)[1] == "bytes"


def test_bytes_only_kernels():
    ms, by = roofline.bound_ms(nbytes=roofline.k2_bytes(1, 1024, 256))
    assert by == "bytes" and ms == pytest.approx(
        4 * (1024 * 9 + 257) / 3.35e12 * 1e3)
    # K4: the uint64 plane of max(ny*W, R+W) rows in, int32 [B, T, 8] out
    assert roofline.k4_work(64, 80, 16, 24, 2)[1] == \
        8 * 2 * 64 * 80 + 4 * 2 * 20 * 8
    # K4's doc512 plane, 8-byte fields: the same bytes as k4_work's input
    assert roofline.plane_bytes(1, 512, 512, 512, word=8) == 512 * 512 * 9
    assert roofline.k1_bytes(2, 640, 512, 1024) == 4 * 2 * (640 * 512
                                                            + 1024 * 8)
    # doc512 at W=16, R=128: 0/1 bytes in, a 512-row int32 plane out
    assert roofline.plane_bytes(1, 512, 512, 512) == 512 * 512 * 5


@pytest.mark.parametrize("T,rounds", [(1, 1), (32, 1), (33, 2), (1024, 32),
                                      (4096, 128)])
def test_k2_rounds_floor(T, rounds):
    assert roofline.k2_rounds_floor(T) == rounds
    assert roofline.k2_rounds_floor(T) == -(-T // decide.ROUND)


@pytest.mark.parametrize("W,R,gh,gw", [(16, 128, 512, 512),
                                       (16, 128, 512, 2048),
                                       (32, 64, 512, 512),
                                       (32, 1024, 1024, 1024),
                                       (8, 16, 64, 64),
                                       (24, 48, 256, 256),
                                       (32, 682, 512, 1024),
                                       (16, 9, 64, 64)])
def test_plan_slices_cover_grid2_once(W, R, gh, gw):
    plan = strict._plan(W, R, gh, gw)
    n, slices = plan["slice_rows"], plan["slices"]
    assert n % strict.RUN2 == 0
    for i0 in range(0, gh, W):
        lo2, hi2 = max(i0 - R, 0), i0 - W
        rows = []
        for s in range(slices):              # as strict_grid2_kernel cuts
            ya = lo2 + s * n
            rows += range(ya, min(ya + n - 1, hi2) + 1)
        assert rows == list(range(lo2, hi2 + 1))
    if plan["ring"]:
        assert plan["ring_bytes"] <= strict.SMEM_MAX
        assert plan["smem"] + strict.SMEM_STATIC <= strict.SMEM_MAX
        assert plan["ring_cols"] == min(max(R, W) + 3 * W, gw)
        # the band's 2W rows and grid 1's last run (at most 6 rows past it)
        assert 2 * W + 6 <= plan["ring_rows"] == 2 * W + 9
        assert plan["ring_bytes"] == plan["ring_cols"] * (2 * W + 9) * 4


def test_plan_ring_and_global_band():
    doc = strict._plan(16, 128, 512, 512)
    assert doc["ring"] and doc["ring_bytes"] == 176 * 41 * 4
    assert doc["slices"] * 32 >= 132                   # grid 2 fills the card
    wide = strict._plan(32, 1024, 1024, 1024)           # 2x2 doc512
    assert not wide["ring"] and wide["smem"] == (32 * 32 + 1) * 4
    # the band fits up to R = 682 at W = 32 on a 1024-wide page
    assert strict._plan(32, 682, 1024, 1024)["ring"]
    assert not strict._plan(32, 683, 1024, 1024)["ring"]


@pytest.mark.parametrize("rows,cols,W,R,B,pops,by", [
    (512, 512, 64, 128, 1, 106502144, "operations"),
    (512, 512, 40, 64, 1, 27296400, "operations"),
    (512, 512, 64, 128, 4, 4 * 106502144, "operations"),
    (75, 101, 33, 40, 1, None, None),
    (16, 105000, 8, 8, 1, None, None)])
def test_k4_work(rows, cols, W, R, B, pops, by):
    """K4 counts the same popcounts as the windows K1 would score, whatever
    its 64-bit fields; its plane has the zero rows of plane_height."""
    got, nbytes = roofline.k4_work(rows, cols, W, R, B)
    assert got == B * roofline.search_popcounts(rows, cols, W, R)
    if pops is not None:
        assert got == pops
        assert roofline.bound_ms(popcounts=got, nbytes=nbytes)[1] == by
    ny, nx = -(-rows // W), -(-cols // W)
    He = fused_search.plane_height(ny * W, W, R)
    assert nbytes == 8 * B * He * nx * W + 4 * B * ny * nx * 8


def test_rans_work_doc512_and_letter_page():
    """K7's geometry, bytes and chain floor: doc512 (4 stripes of 128 rows,
    32 lanes, 2,048 steps) and a 3300 x 2550 letter page (16 stripes of
    207 rows, 16,496 steps)."""
    from binary_image_compression_tpu_torch.models import codec
    from binary_image_compression_tpu_torch.ops import ransdevice
    p = codec.CodecParams(codec=13, W=0, T=0, R=0)
    for rows, cols, sr, steps in ((512, 512, 128, 2048),
                                  (3300, 2550, 207, 16496)):
        tmpl, S, stripe_rows = codec.scab_stripes(p, rows)
        assert (tmpl, stripe_rows) == (12, sr)
        assert ransdevice.stripe_geometry(rows, cols, sr, 32) == (
            S, steps, steps * 16)
    nbytes, floor = roofline.rans_work(512 * 512, 2048, 4, 32)
    assert nbytes == 3 * 262144 + 8192 + 512 + 2 * 262144
    assert roofline.rans_work(512 * 512, 2048, 4, 32, 14000)[0] == \
        3 * 262144 + 8192 + 512 + 14000
    assert floor == pytest.approx(2048 * 40 / 1.98e9 * 1e3)
    assert roofline.rans_work(3300 * 2550, 16496, 16, 32)[1] == \
        pytest.approx(8.0547 * floor, rel=1e-4)
