"""Work counts and least times of the port's kernels on one NVIDIA H100.

The port's counterpart of ``binary_image_compression_tpu/utils/roofline.py``,
with Hopper's figures only.  Every count is a plain integer read off the
shapes a kernel takes; ``bound_ms`` turns a count into the least time the
card could take for it: the larger of the popcount time and the byte time,
each input read once and each output written once.

Rates (NVIDIA H100 SXM at its 700 W limit):
  * popcount: 132 SMs x 16 ``__popc`` per clock x 1.98 GHz (the boost
    clock); the INT32 pipe issues the xor and the add beside it;
  * device memory: 3.35 TB/s (NVIDIA's data sheet).

A window's distance needs its W x W bits XORed with the tile's and counted:
ceil(W*W / 32) popcounts of 32-bit words (8 at W = 16, where K3 packs the
fields of two rows into one word).

K2 and K3 are dependent chains, so their bound is no yardstick of the
chain.  ``k3_chain_floor_ms`` gives the least time of the part of K3 that
must stay in order: grid 1's popcounts on one SM.  K2's step has no such
count (it is latency, not work); chip_smoke measures it on the card.
"""

from __future__ import annotations

H100_SMS = 132
H100_CLOCK_HZ = 1.98e9
H100_POPC_PER_S = 132 * 16 * 1.98e9
H100_SM_POPC_PER_S = 16 * 1.98e9
H100_HBM_BYTES_PER_S = 3.35e12


def bound_ms(*, popcounts: int = 0, nbytes: int = 0) -> tuple[float, str]:
    """(least ms, "operations" or "bytes": which of the two bounds it)."""
    t_ops = popcounts / H100_POPC_PER_S * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def search_candidates(rows: int, cols: int, W: int, R: int) -> tuple[int, int]:
    """(grid-1, grid-2) candidate windows K1 and K3 score on one page.

    Per tile (i0, j0) of the ceil(rows/W) x ceil(cols/W) grid: grid 2
    covers rows max(i0-R, 0)..i0-W x columns max(j0-R, 0)..min(j0+R,
    cols-W); grid 1 rows max(i0-W, 0)..i0 x columns max(j0-R, 0)..j0-W (for
    j0 >= W).  A window at y = i0-W lies in both and counts twice, as in
    ``n_cands``."""
    ny, nx = -(-rows // W), -(-cols // W)
    g1 = g2 = 0
    for tj in range(nx):
        j0 = tj * W
        minj, maxj = max(j0 - R, 0), min(j0 + R, cols - W)
        c1 = j0 - W - minj + 1 if j0 >= W else 0
        c2 = maxj - minj + 1
        for ti in range(ny):
            i0 = ti * W
            if c1 > 0:
                g1 += (i0 - max(i0 - W, 0) + 1) * c1
            r2 = i0 - W - max(i0 - R, 0) + 1
            if r2 > 0 and c2 > 0:
                g2 += r2 * c2
    return g1, g2


def window_popcounts(W: int) -> int:
    """32-bit popcounts of one window's distance: its W x W bits in words."""
    return -(-W * W // 32)


def search_popcounts(rows: int, cols: int, W: int, R: int) -> int:
    """Popcounts of K1's or K3's distances on one page."""
    return sum(search_candidates(rows, cols, W, R)) * window_popcounts(W)


def k1_bytes(B: int, He: int, We: int, T: int) -> int:
    """K1: the int32 field plane [B, He, We] in, int32 [B, T, 8] out."""
    return 4 * B * He * We + 4 * B * T * 8


def k2_bytes(B: int, T: int, M: int) -> int:
    """K2: weights [B, T, 4], has_cands and idx_len [B, T] and enb [M + 1]
    in, int32 [B, T, 3] out."""
    return 4 * (B * T * 4 + 2 * B * T + M + 1) + 4 * B * T * 3


def k3_bytes(gh: int, gw: int, W: int) -> int:
    """K3: the int32 field plane [gh, gw] and enb [W*W + 1] in, the plane
    back, int32 [T, 8] and [T, W] out."""
    T = (gh // W) * (gw // W)
    return 4 * (2 * gh * gw + W * W + 1 + T * 8 + T * W)


def k3_chain_floor_ms(rows: int, cols: int, W: int, R: int) -> float:
    """K3's chain: grid 1's popcounts on one SM."""
    g1, _ = search_candidates(rows, cols, W, R)
    return g1 * window_popcounts(W) / H100_SM_POPC_PER_S * 1e3


def k4_bytes(B: int, T: int, h: int, w: int) -> int:
    """K4: int32 maps [B, T, h, w] and int32 origins [T] x 2 in, int32
    [B, T, 8] out."""
    return 4 * (B * T * h * w + 2 * T) + 4 * B * T * 8


def k5_work(N: int, K: int, nw: int) -> tuple[int, int]:
    """K5: (popcounts, bytes): one per word pair; u32 [N, nw] and [K, nw]
    in, int32 [N, K] out."""
    return N * K * nw, 4 * (N * nw + K * nw + N * K)


def k6_work(N: int, nw: int) -> tuple[int, int]:
    """K6: (popcounts, bytes): one per word; u32 [N, nw] in, int32 [N]
    out."""
    return N * nw, 4 * (N * nw + N)
