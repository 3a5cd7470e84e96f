"""Reference-parity oracles: exact numpy re-derivations of the compress1..8
codelength simulators (compress_test.cpp .. compress8_test.cpp).

These reproduce the reference drivers' *observable outputs* — per-tile search
results (besti, bestj, bestd[, inv]), mode decisions, Golomb bitcounts and
total codelengths — bit-for-bit against goldens generated from the compiled
reference (scripts/gen_goldens.py).  They are the conformance layer behind
the CLI's ``estimate``; the product codecs are models/codec.py and
models/compress.py.  A copy of ``binary_image_compression_tpu/models/
ref_parity.py`` over the port's ``ops/entropy``, plain numpy.

Reference UB is pinned to the shim build's deterministic behaviour
(DEVIATIONS.md): calloc-zeroed allocations (unwritten med origin bit reads
0), x86-64 double->unsigned cast semantics for ceil(log2(0)) (= 2^63).

Everything here is encoder-side estimation, as in the reference; real
bitstreams are models/codec.py.
"""

from __future__ import annotations

import math

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from ..ops.entropy import GolombCoder, enum_codelength

U64 = (1 << 64) - 1
CAST_NEG_INF = 1 << 63  # x86-64 cvttsd2si indefinite value


def c_ulong(x: float) -> int:
    """(unsigned long)(double) with g++/x86-64 semantics (DEVIATIONS.md 4)."""
    if math.isnan(x) or math.isinf(x) or x >= 2.0 ** 64 or x <= -2.0 ** 63:
        return CAST_NEG_INF
    v = int(x)  # C truncation toward zero
    return v & U64


def ceil_log2(x: float) -> int:
    """idx_t(ceil(log2(x))) as the drivers compute it."""
    if x <= 0:
        return CAST_NEG_INF
    return c_ulong(math.ceil(math.log2(x)))


def _tile(img, i0, j0, W):
    """get_submatrix with zero padding beyond the image (ceil-div tiling)."""
    rows, cols = img.shape
    out = np.zeros((W, W), dtype=img.dtype)
    i1, j1 = min(i0 + W, rows), min(j0 + W, cols)
    out[: i1 - i0, : j1 - j0] = img[i0:i1, j0:j1]
    return out


def _med(P):
    """Reference med with the unwritten (0,0) reading calloc-zero."""
    r = np.zeros_like(P)
    r[0, 1:] = P[0, 1:] ^ P[0, :-1]
    r[1:, 0] = P[1:, 0] ^ P[:-1, 0]
    r[1:, 1:] = P[1:, 1:] ^ P[:-1, 1:] ^ P[1:, :-1] ^ P[:-1, :-1]
    r[0, 0] = False
    return r


def _win_dists(img_u8, P, ys, xs, W):
    """Distances from P to candidates at rows ys x cols xs (absolute)."""
    if len(ys) == 0 or len(xs) == 0:
        return np.zeros((0, 0), dtype=np.int32)
    sw = sliding_window_view(img_u8, (W, W))
    block = sw[ys[0]: ys[-1] + 1, xs[0]: xs[-1] + 1]
    d = (block ^ P[None, None]).sum(axis=(-1, -2), dtype=np.int32)
    return d[ys - ys[0]][:, xs - xs[0]]


# ---------------------------------------------------------------------------
# compress_test (c1): full-prior-area search, ascending scan, OOB columns
# ---------------------------------------------------------------------------

def compress1(img: np.ndarray, W: int) -> dict:
    """compress_test.cpp semantics, including the j2 < cols over-scan
    (DEVIATIONS.md 5: bits past the row end read block padding then the next
    row's leading 64-bit block)."""
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    # 64-bit-block extended view: row i continues into zeros up to the block
    # boundary, then row i+1's first 64 bits (binmat get_submatrix straddle)
    bpr64 = -(-cols // 64)
    extw = bpr64 * 64
    ext = np.zeros((rows, extw + 64), dtype=np.uint8)
    ext[:, :cols] = img
    nxt = np.zeros((rows, 64), dtype=np.uint8)
    take = min(64, cols)
    nxt[:-1, :take] = img[1:, :take]
    ext[:, extw:] = nxt
    ext_sw = sliding_window_view(ext, (W, W))

    golomb_match, golomb_nomatch = GolombCoder(), GolombCoder()
    tiles_out, L = [], 0.0
    matches = 0
    average_weight = 0
    li = 0
    for ti in range(ny):
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            P = _tile(img, i0, j0, W).astype(np.uint8)
            besti = bestj = 0
            bestd = M
            pm = False
            # phase A: rows [0, i0-W], all columns [0, cols-1] (over-scan)
            hi = i0 - W  # int(i0 - W): negative for i0 < W
            i2_end = hi
            for i2 in range(0, hi + 1):
                drow = (ext_sw[i2, 0:cols] ^ P[None]).sum(
                    axis=(-1, -2), dtype=np.int32)
                for j2 in range(cols):
                    d = int(drow[j2])
                    if d < bestd:
                        bestd, besti, bestj = d, i2, j2
                    if bestd == 0:
                        pm = True
                        break
                if pm:
                    break
            # phase B: rows (i0-W, i0], columns [0, j0-W]
            if not pm:
                start = max(hi + 1, 0)
                for i2 in range(start, i0 + 1):
                    jhi = j0 - W
                    if jhi < 0:
                        continue
                    drow = (ext_sw[i2, 0: jhi + 1] ^ P[None]).sum(
                        axis=(-1, -2), dtype=np.int32)
                    for j2 in range(jhi + 1):
                        d = int(drow[j2])
                        if d < bestd:
                            bestd, besti, bestj = d, i2, j2
                        if bestd == 0:
                            pm = True
                            break
                    if pm:
                        break
            tiles_out.append([i0, j0, besti, bestj, bestd])
            idx_len = ceil_log2(li)
            wP = int(P.sum())
            nomatch_len = c_ulong(1 + enum_codelength(M, wP))
            # C sums 1 + idx_len (idx_t) + enumL (double) in double, then
            # truncates once at the idx_t assignment
            match_len = c_ulong(float(1 + idx_len) + enum_codelength(M, bestd))
            if nomatch_len > match_len:
                golomb_match.code_sample(bestd)
                average_weight += bestd
                matches += 1
                L += match_len
            else:
                golomb_nomatch.code_sample(wP)
                L += nomatch_len
            li += 1
    n_tiles = ny * nx
    final = _final_metrics(L, golomb_match, golomb_nomatch, matches,
                           average_weight, rows, cols, n_tiles)
    return {"tiles": tiles_out, "final": final}


def _final_metrics(L, gm, gn, matches, average_weight, rows, cols, n_tiles,
                   guard_matches=False, ratio_includes_golomb=False):
    m = matches
    if guard_matches and m == 0:
        m = 1  # the reference's `if (matches == 0) matches++` bump
    out = {}
    if m > 0:
        out["matches"] = m
        out["avg_weight"] = average_weight // m
        out["avg_golomb_match"] = gm.bitcount // m
        nm = n_tiles - m
        out["avg_golomb_nomatch"] = (gn.bitcount // nm if nm != 0 else None)
    out["comp_bytes"] = (L + gm.bitcount + gn.bitcount) / 8.0
    out["raw_bytes"] = rows * cols // 8
    # compress4..8 reassign L += bitcounts before printing RATIO
    # (compress8_test.cpp:313-316); compress1..3 print the raw L ratio
    Lr = L + gm.bitcount + gn.bitcount if ratio_includes_golomb else L
    out["ratio"] = 100.0 * Lr / (rows * cols)
    out["L_bits"] = L
    out["golomb_match_bits"] = gm.bitcount
    out["golomb_nomatch_bits"] = gn.bitcount
    return out


# ---------------------------------------------------------------------------
# compress2/3: dictionary of TILE-INDEX coordinates (yes — the reference
# stores tile loop indices and uses them as pixel coords, compress2:57,108)
# ---------------------------------------------------------------------------

def compress2(img: np.ndarray, W: int) -> dict:
    return _dict_codec(img, W, T=None, golomb=False, weight_len=True)


def compress3(img: np.ndarray, W: int, T: int | None = None) -> dict:
    if T is None:
        T = W * W // 8
    return _dict_codec(img, W, T=T, golomb=True, weight_len=False)


def _dict_codec(img, W, T, golomb, weight_len):
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    img8 = img.astype(np.uint8)
    dictionary: list[tuple[int, int]] = []
    tiles_out = []
    L = 0.0
    matches = 0
    average_weight = 0
    gm, gn = GolombCoder(), GolombCoder()
    wl = 0.5 * math.log2(M) if weight_len else 0.0
    for ti in range(ny):
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            P = _tile(img8, i0, j0, W)
            bestk, bestd = 0, M
            for k, (ci, cj) in enumerate(dictionary):
                d = int((_tile(img8, ci, cj, W) ^ P).sum(dtype=np.int32))
                if d < bestd:
                    bestd, bestk = d, k
                if bestd == 0:
                    break
            tiles_out.append([i0, j0, bestk, bestd, len(dictionary)])
            wP = int(P.sum())
            nomatch_len = c_ulong(1 + enum_codelength(M, wP) + wl)
            if not dictionary:
                dictionary.append((ti, tj))
                L += nomatch_len
                continue
            match_len = c_ulong(1 + math.ceil(math.log2(len(dictionary)))
                                + enum_codelength(M, bestd) + wl)
            if nomatch_len > match_len:
                matches += 1
                L += match_len
                if golomb:
                    gm.code_sample(bestd)
            else:
                if golomb:
                    gn.code_sample(wP)
                if T is None:
                    dictionary.append((ti, tj))
                L += nomatch_len
            if golomb:
                average_weight += bestd
                if bestd > T:
                    dictionary.append((ti, tj))
    final = {"dict_size": len(dictionary)}
    if golomb:
        final.update(_final_metrics(L, gm, gn, matches, average_weight,
                                    rows, cols, ny * nx))
        final["crashes_if_no_matches"] = matches == 0
    else:
        final.update({"comp_bits": L, "raw_bits": rows * cols,
                      "ratio": 100.0 * L / (rows * cols)})
    return {"tiles": tiles_out, "final": final}


# ---------------------------------------------------------------------------
# compress4/5/6: bounded-window causal search with in-place residual subst.
# ---------------------------------------------------------------------------

def _window_scan_c456(img8, P, i0, j0, W, R, T, rows, cols, cmp5):
    """Serial scan over the c4/5/6 window geometry (unclamped j0-W in
    phase 1 — unlike c7/c8).  Returns (besti, bestj, bestd)."""
    M = W * W
    worstd = M // 2
    besti = bestj = 0
    bestd = M + 1
    pm = False
    mini = i0 - R if i0 > R else 0
    mini2 = i0 - W if i0 > W else 0
    minj = j0 - R if j0 > R else 0
    maxj = (cols - W) if (j0 + R) > (cols - W) else (j0 + R)

    def better(d):
        if cmp5:
            return ((d - worstd) & U64) > ((bestd - worstd) & U64)
        return d < bestd

    sw = sliding_window_view(img8, (W, W))
    # phase 1: i2 = i0 .. mini2 desc; j2 = j0-W .. minj desc (j0-W unclamped)
    jhi = j0 - W
    if jhi >= minj:
        d_blk = (sw[mini2: i0 + 1, minj: jhi + 1] ^ P[None, None]).sum(
            axis=(-1, -2), dtype=np.int32)
        for i2 in range(i0, mini2 - 1, -1):
            for j2 in range(jhi, minj - 1, -1):
                d = int(d_blk[i2 - mini2, j2 - minj])
                if better(d):
                    bestd, besti, bestj = d, i2, j2
                if bestd <= T:
                    pm = True
                    break
            if pm:
                break
    # phase 2: i2 = i0-W .. mini desc; j2 = maxj .. minj desc
    if not pm and i0 - W >= mini:
        d_blk = (sw[mini: i0 - W + 1, minj: maxj + 1] ^ P[None, None]).sum(
            axis=(-1, -2), dtype=np.int32)
        for i2 in range(i0 - W, mini - 1, -1):
            for j2 in range(maxj, minj - 1, -1):
                d = int(d_blk[i2 - mini, j2 - minj])
                if better(d):
                    bestd, besti, bestj = d, i2, j2
                if bestd <= T:
                    pm = True
                    break
            if pm:
                break
    return besti, bestj, bestd


def compress4(img, W, T=0, R=10000):
    return _c456(img, W, T, R, cmp5=False)


def compress5(img, W, T=0, R=10000):
    return _c456(img, W, T, R, cmp5=True)


def compress6(img, W, T=0, R=10000):
    # the predictive-weight branch is #if 0 in the reference
    # (compress6_test.cpp:172-185), so c6 == c4 arithmetic with the
    # match-length guard replaced by the plain formula
    return _c456(img, W, T, R, cmp5=False, c6=True)


def _c456(img, W, T, R, cmp5, c6=False):
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    # working image is padded to full tiles: set_submatrix writes residuals
    # into the padded area exactly as the reference writes into I
    work = np.zeros((ny * W, nx * W), dtype=np.uint8)
    work[:rows, :cols] = img
    # NOTE: the reference searches within the *unpadded* image but reads
    # tiles with get_submatrix clamped by assert...  tiles beyond bounds get
    # zeros; candidate windows are bounded by cols-W/rows which we honor.
    tiles_out, L = [], 0.0
    matches = 0
    average_weight = 0
    gm, gn = GolombCoder(), GolombCoder()
    li = 0
    # the reference's spatial diagnostics (compress4_test.cpp:139-141,
    # 185-188): best-match row/col/radius histograms over ALL tiles and the
    # matched-weight histogram (log-scaled in print_hist)
    hist_w = np.zeros(M + 1, dtype=np.int64)
    hist_i = np.zeros(ny * W, dtype=np.int64)
    hist_j = np.zeros(nx * W, dtype=np.int64)
    hist_r = np.zeros(int(np.ceil(np.hypot(ny * W, nx * W))) + 1,
                      dtype=np.int64)
    for ti in range(ny):
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            P = work[i0:i0 + W, j0:j0 + W].copy()
            besti, bestj, bestd = _window_scan_c456(
                work[:rows, :cols] if (rows % W == 0 and cols % W == 0)
                else work, P, i0, j0, W, R, T, rows, cols, cmp5)
            tiles_out.append([i0, j0, besti, bestj, bestd])
            hist_i[besti] += 1
            hist_j[bestj] += 1
            hist_r[int(np.sqrt(float(besti * besti + bestj * bestj)))] += 1
            P2 = work[besti:besti + W, bestj:bestj + W]
            P3 = P ^ P2
            wP = int(P.sum())
            idx_len = ceil_log2(li)
            if c6:
                if bestd <= M:
                    match_weight = int(P3.sum())
                else:
                    match_weight = wP  # P3 = P.get_copy()
                    P3 = P.copy()
                nomatch_len = c_ulong(1 + enum_codelength(M, wP))
                match_len = c_ulong(float(1 + idx_len)
                                    + enum_codelength(M, match_weight))
                g_m_sample, g_n_sample = match_weight, wP
                avg_inc = match_weight
            else:
                nomatch_len = c_ulong(1 + enum_codelength(M, wP))
                if bestd <= M:
                    match_len = c_ulong(float(1 + idx_len)
                                        + enum_codelength(M, bestd))
                else:
                    match_len = 100000
                g_m_sample, g_n_sample = bestd, wP
                avg_inc = bestd
            if nomatch_len > match_len:
                gm.code_sample(g_m_sample)
                matches += 1
                average_weight += avg_inc
                if avg_inc <= M:
                    hist_w[avg_inc] += 1
                L += match_len
                work[i0:i0 + W, j0:j0 + W] = P3
            else:
                gn.code_sample(g_n_sample)
                L += nomatch_len
            li += 1
    final = _final_metrics(L, gm, gn, matches, average_weight, rows, cols,
                           ny * nx, guard_matches=c6,
                           ratio_includes_golomb=True)
    final["crashes_if_no_matches"] = (not c6) and matches == 0
    final["hist_weight"] = hist_w.tolist()
    final["hist_besti"] = hist_i.tolist()
    final["hist_bestj"] = hist_j.tolist()
    final["hist_radius"] = hist_r.tolist()
    return {"tiles": tiles_out, "final": final}


# ---------------------------------------------------------------------------
# compress7/8: 4-way mode {match,nomatch}x{pred,nonpred} (+inversion in c8)
# ---------------------------------------------------------------------------

def _window_scan_c78(work8, P, i0, j0, W, R, T, rows, cols, invert,
                     pm_init, inv_defined):
    """inv_defined=False (parity default) reproduces the shim build: the
    reference reads `inv` uninitialized on the (M-d) >= d path
    (compress8_test.cpp:153-160); since its only store is `inv = true`, g++
    -O3 legally folds the read to constant true, so EVERY search-selected
    candidate reports inv=1 (verified against goldens — c8 tiles show inv=1
    iff the search ran).  inv_defined=True uses inv = (M-d) < d
    (DEVIATIONS.md item 3), which the product codec uses."""
    M = W * W
    besti = bestj = 0
    bestd = M + 1
    bestinv = ((int(P.sum()) - M) & U64) < int(P.sum()) if invert else False
    pm = pm_init
    mini = i0 - R if i0 > R else 0
    minj = j0 - R if j0 > R else 0
    maxj = (cols - W) if (j0 + R) > (cols - W) else (j0 + R)
    mini2 = i0 - W if i0 > W else 0
    maxj2 = j0 - W if j0 > W else 0
    sw = sliding_window_view(work8, (W, W))

    def scan(ylo, yhi, xlo, xhi):
        nonlocal besti, bestj, bestd, bestinv, pm
        if yhi < ylo or xhi < xlo or pm:
            return
        d_blk = (sw[ylo: yhi + 1, xlo: xhi + 1] ^ P[None, None]).sum(
            axis=(-1, -2), dtype=np.int32)
        for i2 in range(yhi, ylo - 1, -1):
            for j2 in range(xhi, xlo - 1, -1):
                d = int(d_blk[i2 - ylo, j2 - xlo])
                inv = True  # folded-UB semantics
                if invert:
                    if (M - d) < d:
                        d = M - d
                    elif inv_defined:
                        inv = False
                if d < bestd:
                    bestinv = inv if invert else False
                    bestd, besti, bestj = d, i2, j2
                    if bestd <= T:
                        pm = True
                        return

    # scan order: grid1 (same rows behind) then grid2 (rows above), each
    # iterated i2 desc, j2 desc
    scan(mini2, i0, minj, maxj2)
    if not pm:
        scan(mini, i0 - W, minj, maxj)
    sws = (i0 - mini2) * (maxj2 - minj) + (mini2 - mini) * (maxj - minj)
    return besti, bestj, bestd, bestinv, sws


def compress7(img, W, T=0, R=128):
    return _c78(img, W, T, R, invert=False)


def compress8(img, W, T=None, R=128, inv_defined=False):
    M = W * W
    goodT = c_ulong(math.ceil(math.log2((2 * R + 1) * R))
                    / math.ceil(math.log2(M)))
    if T is None:
        T = goodT
    return _c78(img, W, T, R, invert=True, inv_defined=inv_defined)


def _c78(img, W, T, R, invert, inv_defined=False):
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    ny, nx = -(-rows // W), -(-cols // W)
    M = W * W
    work = np.zeros((ny * W, nx * W), dtype=np.uint8)
    work[:rows, :cols] = img
    tiles_out, mode_map, L = [], [], 0.0
    matches = 0
    average_weight = 0
    gm, gn = GolombCoder(), GolombCoder()
    for ti in range(ny):
        row_modes = []
        for tj in range(nx):
            i0, j0 = ti * W, tj * W
            P = work[i0:i0 + W, j0:j0 + W].copy()
            wP = int(P.sum())
            pm_init = invert and ((wP <= T) or (wP >= M - T))
            besti, bestj, bestd, bestinv, sws = _window_scan_c78(
                work, P, i0, j0, W, R, T, rows, cols, invert, pm_init,
                inv_defined)
            rec = [i0, j0, besti, bestj, bestd]
            if invert:
                rec.append(int(bestinv))
            tiles_out.append(rec)
            if bestinv:
                P = 1 - P
            if bestd <= M:
                P2 = work[besti:besti + W, bestj:bestj + W]
                P3 = P ^ P2
            else:
                P3 = P.copy()
            m_np_w = int(P3.sum())
            nm_np_w = int(P.sum())
            dP = _med(P.astype(bool)).astype(np.uint8)
            dP3 = _med(P3.astype(bool)).astype(np.uint8)
            m_p_w = int(dP3.sum())
            nm_p_w = int(dP.sum())
            idx_len = ceil_log2(sws)
            base = 2 if not invert else 2
            mbase = 2 if not invert else 3
            nm_np_len = c_ulong(base + enum_codelength(M, nm_np_w))
            nm_p_len = c_ulong(base + enum_codelength(M, nm_p_w))
            m_np_len = c_ulong(float(mbase + idx_len)
                               + enum_codelength(M, m_np_w))
            m_p_len = c_ulong(float(mbase + idx_len)
                              + enum_codelength(M, m_p_w))
            if m_np_len > m_p_len:
                match_len, match_weight, res_m, mmode = \
                    m_p_len, m_p_w, dP3, "X"
            else:
                match_len, match_weight, res_m, mmode = \
                    m_np_len, m_np_w, P3, "x"
            if nm_np_len > nm_p_len:
                nomatch_len, nomatch_weight, res_n, nmode = \
                    nm_p_len, nm_p_w, dP, "O"
            else:
                nomatch_len, nomatch_weight, res_n, nmode = \
                    nm_np_len, nm_np_w, P, "o"
            if nomatch_len > match_len:
                gm.code_sample(match_weight)
                average_weight += match_weight
                matches += 1
                L += match_len
                work[i0:i0 + W, j0:j0 + W] = res_m
                row_modes.append(mmode)
            else:
                gn.code_sample(nomatch_weight)
                L += nomatch_len
                work[i0:i0 + W, j0:j0 + W] = res_n
                row_modes.append(nmode)
        mode_map.append("".join(row_modes))
    final = _final_metrics(L, gm, gn, matches, average_weight, rows, cols,
                           ny * nx, guard_matches=True,
                           ratio_includes_golomb=True)
    final["map"] = mode_map
    return {"tiles": tiles_out, "final": final}
