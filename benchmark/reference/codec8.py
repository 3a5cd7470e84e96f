"""Plain reference of the windowed codecs 4, 7 and 8 in causal mode.

Written from the BIC1 format and the reference encoder's rules, with no
code of the program: the same page gives the same stream, byte for byte.

Per W x W tile (i0, j0) of the zero-padded page, in raster order:
  * candidates in scan order: grid 1 (j0 >= W) rows i0 down to
    max(i0-W, 0), each row from column j0-W down to max(j0-R, 0); then
    grid 2, rows i0-W down to max(i0-R, 0), each from min(j0+R, cols-W)
    down to max(j0-R, 0);
  * d = Hamming distance of the window to the tile; codec 8 inverts
    (d -> M - d, inv = 1) where M - d < d;
  * the serial scan keeps a candidate that beats the best so far and stops
    at the first best with d <= T: the first candidate with d <= T, else
    the first of the smallest d;
  * four residuals: the match (tile ^ inv ^ window) and its MED, the tile
    and its MED; the cheapest by two adaptive Golomb contexts (matches,
    non-matches) plus the enumerative rank's bits is written.

The search is plain PyTorch: every window's distance to the tiles of one
tile row is a matrix product of 0/1 vectors, exact in float32 with TF32
off.  The rest is numpy and Python integers.
"""

from __future__ import annotations

import math
import struct
import zlib
from functools import lru_cache

import numpy as np
import torch

MAGIC = b"BIC1"


def auto_T(W: int, R: int) -> int:
    """compress8's threshold: ceil(log2((2R+1) R)) // ceil(log2(W*W))."""
    clog2 = lambda n: (n - 1).bit_length()
    return clog2((2 * R + 1) * R) // clog2(W * W)


def header(codec: int, strict: bool, W: int, rows: int, cols: int, T: int,
           R: int, crc: int) -> bytes:
    """The 28-byte BIC1 header."""
    return MAGIC + struct.pack("<IBBHIIII", crc, codec, int(strict), W, rows,
                               cols, T, R)


def image_crc(img: np.ndarray) -> int:
    """CRC-32 of the page's bits packed MSB-first, row after row."""
    return zlib.crc32(np.packbits(np.asarray(img, dtype=bool)).tobytes())


def _offsets(W: int, R: int):
    """(dy, dx, grid) of every candidate relative to its tile, in scan
    order, before clipping to the page."""
    dy, dx, grid = [], [], []
    for y in range(0, -W - 1, -1):
        for x in range(-W, -R - 1, -1):
            dy.append(y), dx.append(x), grid.append(1)
    for y in range(-W, -R - 1, -1):
        for x in range(R, -R - 1, -1):
            dy.append(y), dx.append(x), grid.append(2)
    return (np.asarray(dy, np.int64), np.asarray(dx, np.int64),
            np.asarray(grid, np.int64))


def search(G: np.ndarray, rows: int, cols: int, W: int, R: int, T: int,
           invert: bool, device="cpu") -> dict:
    """The serial scan's choice for every tile, int64 numpy [ny * nx]:
    y, x (the window), inv, n_cands, rank (the window's place in the scan)
    and scanned (how many candidates the scan reads before it stops)."""
    gh, gw = G.shape
    ny, nx, M = gh // W, gw // W, W * W
    dev = torch.device(device)
    dy, dx, grid = (torch.from_numpy(a).to(dev) for a in _offsets(W, R))
    K = dy.numel()
    Gt = torch.from_numpy(G.astype(np.float32)).to(dev)
    j0 = torch.arange(nx, device=dev)[:, None] * W
    ar = torch.arange(K, device=dev).expand(nx, K)
    keys = ("y", "x", "inv", "n_cands", "rank", "scanned")
    out = {k: [] for k in keys}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for ti in range(ny):
            i0 = ti * W
            ylo = max(i0 - R, 0)
            Lx = gw - W + 1
            # every window with its top in rows ylo..i0: [M, Ly * Lx]
            Q = torch.nn.functional.unfold(Gt[None, None, ylo:i0 + W],
                                           (W, W))[0]
            tiles = Gt[i0:i0 + W].reshape(W, nx, W).transpose(0, 1)
            tiles = tiles.reshape(nx, M)
            corr = tiles @ Q
            d_all = (tiles.sum(1)[:, None] + Q.sum(0)[None]
                     - 2 * corr).round().to(torch.int64)
            y = (i0 + dy)[None].expand(nx, K)
            x = j0 + dx[None]
            valid = (y >= 0) & (x >= 0) & torch.where(
                grid[None] == 1, j0 >= W, x <= cols - W)
            li = torch.where(valid, (y - ylo) * Lx + x, 0)
            d = torch.gather(d_all, 1, li)
            inv = ((M - d) < d) & invert
            d = torch.where(inv, M - d, d)
            n_cands = valid.sum(1)
            hit = torch.where(valid & (d <= T), ar, K).min(1).values
            dmin = torch.where(valid, d, M + 1).min(1).values
            first_min = torch.where(valid & (d == dmin[:, None]), ar,
                                    K).min(1).values
            sel = torch.where(hit < K, hit, first_min).clamp(max=K - 1)
            rank = torch.gather(valid.cumsum(1), 1, sel[:, None])[:, 0] - 1
            pick = lambda t: torch.gather(t, 1, sel[:, None])[:, 0]
            found = n_cands > 0
            out["y"].append(torch.where(found, pick(y), -1))
            out["x"].append(torch.where(found, pick(x), -1))
            out["inv"].append(found & pick(inv))
            out["n_cands"].append(n_cands)
            out["rank"].append(torch.where(found, rank, -1))
            out["scanned"].append(torch.where(hit < K, rank + 1, n_cands))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {k: torch.cat(v).to(torch.int64).cpu().numpy()
            for k, v in out.items()}


def med(t: np.ndarray) -> np.ndarray:
    """MED residual of tiles [..., W, W]: t ^ up ^ left ^ up-left, zero
    outside the tile."""
    up = np.zeros_like(t)
    up[..., 1:, :] = t[..., :-1, :]
    left = np.zeros_like(t)
    left[..., :, 1:] = t[..., :, :-1]
    ul = np.zeros_like(t)
    ul[..., 1:, 1:] = t[..., :-1, :-1]
    return t ^ up ^ left ^ ul


@lru_cache(maxsize=None)
def binomials(n: int) -> tuple:
    """C(a, r) for a in 0..n, r in 0..n+1, as Python integers."""
    return tuple(tuple(math.comb(a, r) for r in range(n + 2))
                 for a in range(n + 1))


@lru_cache(maxsize=None)
def enum_bits(n: int) -> tuple:
    """Bits of the enumerative rank of an n-bit vector of weight w:
    bit_length(C(n, w) - 1)."""
    return tuple((math.comb(n, w) - 1).bit_length() for w in range(n + 1))


def enum_rank(bits: np.ndarray) -> int:
    """Rank of a 0/1 vector among those of its weight: the sum, over each
    0 at position q with r ones still to come, of C(n-1-q, r-1).  Summed
    gap by gap (the hockey-stick identity), so its cost is the weight."""
    n = bits.size
    C = binomials(n)
    ones = np.flatnonzero(bits).tolist()
    w = len(ones)
    rank, prev = 0, -1
    for k, p in enumerate(ones, start=1):
        r = w - k + 1
        rank += C[n - 1 - prev][r] - C[n - p][r]
        prev = p
    return rank


def _golomb(state: list, u: int) -> str:
    """Bits of u under an adaptive Golomb context [acc, samples, k]: the
    low k bits, u >> k zeros and a 1; then k = the least k' with
    samples << k' >= acc."""
    k = state[2]
    bits = (format(u & ((1 << k) - 1), f"0{k}b") if k else "") \
        + "0" * (u >> k) + "1"
    state[0] += u
    state[1] += 1
    kk = 0
    while kk < 31 and (state[1] << kk) < state[0]:
        kk += 1
    state[2] = kk
    return bits


def _bytes_of(bitstr: str) -> bytes:
    a = np.frombuffer(bitstr.encode(), dtype=np.uint8) - ord("0")
    return np.packbits(a).tobytes()


def _grid(img: np.ndarray, W: int) -> np.ndarray:
    """The page zero-padded to whole tiles, uint8."""
    rows, cols = img.shape
    G = np.zeros((-(-rows // W) * W, -(-cols // W) * W), dtype=np.uint8)
    G[:rows, :cols] = img
    return G


def _settings(codec: int, W: int, T: int | None, R: int):
    invert = codec == 8
    T = (auto_T(W, R) if codec == 8 else 0) if T is None else T
    return T, invert


def scanned(img: np.ndarray, *, codec: int = 8, W: int = 16,
            T: int | None = None, R: int = 128, device="cpu") -> int:
    """Candidates the serial scan reads on a page, summed over its tiles:
    up to the first within T, else all (the search's need)."""
    img = np.asarray(img, dtype=bool)
    T, invert = _settings(codec, W, T, R)
    return int(search(_grid(img, W), *img.shape, W, R, T, invert,
                      device)["scanned"].sum())


def encode(img: np.ndarray, *, codec: int = 8, W: int = 16,
           T: int | None = None, R: int = 128, device="cpu") -> bytes:
    """The causal BIC1 stream of a page (codec 4, 7 or 8)."""
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    T, invert = _settings(codec, W, T, R)
    use_pred = codec in (7, 8)
    ny, nx, M = -(-rows // W), -(-cols // W), W * W
    G = _grid(img, W)
    s = search(G, rows, cols, W, R, T, invert, device)
    a = np.arange(W)
    P = G.reshape(ny, W, nx, W).transpose(0, 2, 1, 3).reshape(-1, W, W)
    found = s["n_cands"] > 0
    ys, xs = np.maximum(s["y"], 0), np.maximum(s["x"], 0)
    win = G[ys[:, None, None] + a[None, :, None],
            xs[:, None, None] + a[None, None, :]]
    P3 = (P ^ s["inv"].astype(np.uint8)[:, None, None]) ^ win
    res4 = np.stack([P3, med(P3), P, med(P)], axis=1).reshape(-1, 4, M)
    w4 = res4.sum(-1).astype(np.int64)
    enb = enum_bits(M)
    mcost = 1 + use_pred + invert
    ncost = 1 + use_pred
    BIG = 1 << 40
    gm, gn = [0, 0, 1], [0, 0, 1]
    gk = lambda g, u: g[2] + (u >> g[2]) + 1
    parts = []
    for t in range(ny * nx):
        w = w4[t].tolist()
        n = int(s["n_cands"][t])
        il = max(1, (n - 1).bit_length()) if n else 0
        costs = [
            mcost + il + gk(gm, w[0]) + enb[w[0]] if found[t] else BIG,
            mcost + il + gk(gm, w[1]) + enb[w[1]]
            if found[t] and use_pred else BIG,
            ncost + gk(gn, w[2]) + enb[w[2]],
            ncost + gk(gn, w[3]) + enb[w[3]] if use_pred else BIG]
        mode = costs.index(min(costs))
        res = res4[t, mode]
        wt = w[mode]
        if mode < 2:
            parts.append("1" + (str(mode & 1) if use_pred else "")
                         + (str(int(s["inv"][t])) if invert else "")
                         + (format(int(s["rank"][t]), f"0{il}b")
                            if il else ""))
            parts.append(_golomb(gm, wt))
        else:
            parts.append("0" + (str(mode & 1) if use_pred else ""))
            parts.append(_golomb(gn, wt))
        if enb[wt]:
            parts.append(format(enum_rank(res), f"0{enb[wt]}b"))
    return (header(codec, False, W, rows, cols, T, R, image_crc(img))
            + _bytes_of("".join(parts)))


def stream(page: np.ndarray, config: dict, device="cpu") -> bytes:
    """The stream of a page under a configuration's settings."""
    return encode(page, codec=config["codec"], W=config["W"], T=config["T"],
                  R=config["R"], device=device)
