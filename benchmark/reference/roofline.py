"""The benchmark's yardstick: work counts and least times on one H100.

A frozen copy of the counting functions that the roofline metrics use
(``search_candidates``, ``window_popcounts``, ``search_popcounts``,
``k1_bytes``, ``rans_work``, ``bound_ms``) and the rates they are held
to.  It imports nothing of the program: a change to the program's own
counts cannot move the benchmark's.  ``tests/test_benchmark_yardstick.py``
holds the copy equal to the program's functions on the cells' shapes.

Rates (NVIDIA H100 SXM data sheet, at its 700 W limit):
  * popcount: 132 SMs x 16 ``__popc`` per clock x 1.98 GHz (boost clock);
  * device memory: 3.35 TB/s.
"""

from __future__ import annotations

H100_SMS = 132
H100_CLOCK_HZ = 1.98e9
H100_POPC_PER_S = H100_SMS * 16 * H100_CLOCK_HZ
H100_HBM_BYTES_PER_S = 3.35e12
# K7's chain: dependent instructions a rANS step and clocks each
# (a yardstick in PERF.md, not a metric)
ALU_DEPENDENT_CLOCKS = 4
RANS_STEP_DEPENDENT_OPS = 10


def bound_ms(*, popcounts: int = 0, nbytes: int = 0) -> tuple[float, str]:
    """(least ms, "operations" or "bytes": which of the two bounds it)."""
    t_ops = popcounts / H100_POPC_PER_S * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def search_candidates(rows: int, cols: int, W: int, R: int) -> tuple[int, int]:
    """(grid-1, grid-2) candidate windows of the causal search on one page:
    per tile (i0, j0), grid 2 covers rows max(i0-R, 0)..i0-W x columns
    max(j0-R, 0)..min(j0+R, cols-W); grid 1 rows max(i0-W, 0)..i0 x columns
    max(j0-R, 0)..j0-W (for j0 >= W)."""
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
    """Popcounts of every candidate window's distance on one page."""
    return sum(search_candidates(rows, cols, W, R)) * window_popcounts(W)


def k1_bytes(B: int, He: int, We: int, T: int) -> int:
    """K1: the int32 field plane [B, He, We] in, int32 [B, T, 8] out."""
    return 4 * B * He * We + 4 * B * T * 8


def k1_plane_height(gh: int, W: int, R: int) -> int:
    """Rows of K1's field plane: the padded grid and the zero rows that
    keep a bottom tile's band of R + 1 candidate rows inside it."""
    return gh + max(0, (R + 1) - (gh - W + 1))


def rans_work(pixels: int, steps: int, S: int, N: int,
              out_bytes: int | None = None) -> tuple[int, float]:
    """K7 on S stripes of N lanes and `steps` steps: (bytes, chain floor in
    ms).  Bytes: the page's bits (1 B a pixel) and contexts (2 B) read once,
    the 8 KB table once, the states (4 B a lane) and the stream written
    once (`out_bytes` where known, else at most 2 B a pixel)."""
    out = 2 * pixels if out_bytes is None else out_bytes
    nbytes = 3 * pixels + 2 * 4096 + 4 * S * N + out
    floor_ms = (steps * RANS_STEP_DEPENDENT_OPS * ALU_DEPENDENT_CLOCKS
                / H100_CLOCK_HZ * 1e3)
    return nbytes, floor_ms
