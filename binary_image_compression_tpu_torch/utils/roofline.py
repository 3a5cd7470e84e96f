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

K4 scores the same windows as K1 over a plane of 64-bit fields; its count
is the windows' popcounts all the same (128 at W = 64).

K2 and K3 are dependent chains, so their bound is no yardstick of the
chain.  ``k3_chain_floor_ms`` gives the least time of the part of K3 that
must stay in order: grid 1's popcounts on one SM.  K2 decides a page in
rounds of up to 32 tiles, so ``k2_rounds_floor`` is the least number of
rounds a page of T tiles takes; a round's time is latency, not work, and
chip_smoke measures it on the card.

The BSVD pursuit's work depends on the data: ``pursuit_work`` takes the
distance passes the rows took (the kernel counts them per row).

K7, codec 13's interleaved-rANS encode, is a chain per lane as well: each
lane's steps depend on the one before.  ``rans_work`` gives its bytes and
its chain floor, the steps times the least latency of one step's
dependent instructions on one lane (``RANS_STEP_DEPENDENT_OPS`` of them,
``ALU_DEPENDENT_CLOCKS`` each, at the boost clock).

K9, codec 8's record pack, reads the decided record block and writes the
payload; ``k9_bytes`` counts both once (its binomial table is a constant
the work could do without, so it is not counted).

K8, codec 10's adaptive exp-Golomb coder, reads a packed residual plane
and writes its payload; the order of the runs is a composition of 32-state
maps, whose least chain is a scan of ceil(log2(runs)) levels, each
``EG_COMPOSE_DEPENDENT_OPS`` dependent operations.  ``eg_work`` gives both.
"""

from __future__ import annotations

H100_SMS = 132
H100_CLOCK_HZ = 1.98e9
H100_POPC_PER_S = 132 * 16 * 1.98e9
H100_SM_POPC_PER_S = 16 * 1.98e9
H100_HBM_BYTES_PER_S = 3.35e12
# clocks from issuing an integer ALU or IMAD instruction to issuing one that
# reads its result: 4 on Volta-class and later SMs (Jia et al. 2018,
# "Dissecting the NVIDIA Volta GPU Architecture via Microbenchmarking")
ALU_DEPENDENT_CLOCKS = 4
# one rANS encode step's instructions on the state's dependent chain, with
# everything that depends only on f (the divisor's reciprocal) off it:
# shift and compare (need), select (renormalise), the divide's multiply-high,
# multiply-subtract (remainder), compare and fix-up, then shift-add and add
# (the new state)
RANS_STEP_DEPENDENT_OPS = 10
# one level of a scan of (32-state map, code length) pairs: the map read at
# the entering state, and the length read there and added
EG_COMPOSE_DEPENDENT_OPS = 2


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


def plane_bytes(B: int, gh: int, gw: int, He: int, word: int = 4) -> int:
    """A plane kernel: 0/1 bytes [B, gh, gw] in, the field plane [B, He, gw]
    of `word`-byte fields out (4 for K1's, 8 for K4's)."""
    return B * gh * gw + word * B * He * gw


def k2_bytes(B: int, T: int, M: int) -> int:
    """K2: weights [B, T, 4], has_cands and idx_len [B, T] and enb [M + 1]
    in, int32 [B, T, 3] out."""
    return 4 * (B * T * 4 + 2 * B * T + M + 1) + 4 * B * T * 3


def k2_rounds_floor(T: int) -> int:
    """K2's least rounds for a page of T tiles: one per window of 32."""
    return -(-T // 32)


def k3_bytes(gh: int, gw: int, W: int) -> int:
    """K3: the int32 field plane [gh, gw] and enb [W*W + 1] in, the plane
    back, int32 [T, 8] and [T, W] out."""
    T = (gh // W) * (gw // W)
    return 4 * (2 * gh * gw + W * W + 1 + T * 8 + T * W)


def k3_chain_floor_ms(rows: int, cols: int, W: int, R: int) -> float:
    """K3's chain: grid 1's popcounts on one SM."""
    g1, _ = search_candidates(rows, cols, W, R)
    return g1 * window_popcounts(W) / H100_SM_POPC_PER_S * 1e3


def k4_work(rows: int, cols: int, W: int, R: int, B: int = 1
            ) -> tuple[int, int]:
    """K4, the banded search and selection: (popcounts, bytes).  The
    windows' popcounts whatever the word width that implements them; the
    uint64 field plane [B, He, nx*W] in (He = max(ny*W, R+W), ops/
    fused_search.plane_height), int32 [B, T, 8] out."""
    ny, nx = -(-rows // W), -(-cols // W)
    He = max(ny * W, R + W)
    pops = B * search_popcounts(rows, cols, W, R)
    return pops, 8 * B * He * nx * W + 4 * B * ny * nx * 8


def k5_work(N: int, K: int, nw: int) -> tuple[int, int]:
    """K5: (popcounts, bytes): one per word pair; u32 [N, nw] and [K, nw]
    in, int32 [N, K] out."""
    return N * K * nw, 4 * (N * nw + K * nw + N * K)


def k6_work(N: int, nw: int) -> tuple[int, int]:
    """K6: (popcounts, bytes): one per word; u32 [N, nw] in, int32 [N]
    out."""
    return N * nw, 4 * (N * nw + N)


def pursuit_work(passes: int, N: int, K: int, nw: int) -> tuple[int, int]:
    """The BSVD pursuit kernel: (popcounts, bytes).  `passes` is the sum of
    the rows' distance passes (what this run's data needed): K * nw
    popcounts each, plus N * nw for the first |E_i|.  Bytes: the packed
    rows [N, nw] in and out, D [K, nw] once, the passes [N] out, and A's
    toggled bytes, read and written: at least passes - N of them, since a
    row's passes are its flips plus at most one that fails."""
    pops = passes * K * nw + N * nw
    return pops, 4 * (2 * N * nw + K * nw + N) + 2 * max(passes - N, 0)


def rans_work(pixels: int, steps: int, S: int, N: int,
              out_bytes: int | None = None) -> tuple[int, float]:
    """K7 on S stripes of N lanes and `steps` steps: (bytes, chain floor in
    ms).  Bytes: the page's bits (1 B a pixel) and contexts (2 B) read once,
    the 8 KB table (4,096 u16) once, the states (4 B a lane) and the stream
    written once: `out_bytes` where the run knows it, else at most 2 B a
    pixel.  The chain floor: every lane walks all the steps, each at least
    RANS_STEP_DEPENDENT_OPS x ALU_DEPENDENT_CLOCKS clocks."""
    out = 2 * pixels if out_bytes is None else out_bytes
    nbytes = 3 * pixels + 2 * 4096 + 4 * S * N + out
    floor_ms = (steps * RANS_STEP_DEPENDENT_OPS * ALU_DEPENDENT_CLOCKS
                / H100_CLOCK_HZ * 1e3)
    return nbytes, floor_ms


def eg_work(n_pixels: int, n_runs: int, payload_bits: int,
            planes: int = 1) -> tuple[int, float]:
    """K8 on `planes` residual planes of n_pixels each (n_runs and
    payload_bits summed over them): (bytes, chain floor in ms).  Bytes:
    the packed residual read once (rows padded to whole words are not
    counted: at most 4 B a row more), the payload words and a bit count
    (8 B) per plane written once.  The chain floor: a scan of the runs' maps
    in ceil(log2(runs a plane)) levels, each EG_COMPOSE_DEPENDENT_OPS x
    ALU_DEPENDENT_CLOCKS clocks."""
    nbytes = planes * (-(-n_pixels // 8) + 8) + 4 * -(-payload_bits // 32)
    per_plane = max(2, -(-n_runs // max(1, planes)))
    levels = (per_plane - 1).bit_length()
    floor_ms = (levels * EG_COMPOSE_DEPENDENT_OPS * ALU_DEPENDENT_CLOCKS
                / H100_CLOCK_HZ * 1e3)
    return nbytes, floor_ms


def k9_bytes(B: int, T: int, nw: int, payload_words: int) -> int:
    """K9 on B pages of T tiles: the int32 [B, T, 2 + nw] record block read
    once; the payload's words and two int64 a page (its bit count and
    first word) written once."""
    return 4 * B * T * (2 + nw) + 4 * payload_words + 16 * B
