"""Kernel K2: per-tile mode decision with two adaptive Golomb contexts.

Counterpart of ``binary_image_compression_tpu/ops/pallas_decide.py``
(``decide_modes``).  Per tile, in raster order, the cheapest of up to four
codings {match, nomatch} x {nonpred, pred} wins (first minimum on ties), and
the chosen weight updates that mode's Golomb context (GolombCoder.cpp:29-33,
32-bit unsigned wraparound, k starting at 1).  The chain is serial over the
tiles of a page; pages are independent.

``decide_modes`` launches ``csrc/decide_modes.cu`` for CUDA tensors and
runs ``decide_modes_plain`` for CPU tensors.  The kernel decides a window
of 32 tiles in speculative rounds; ``decide_rounds_model`` is a numpy model
of that order of work (the same windows, commit rule and guard) that also
counts the rounds, and ``golomb_k_lane`` mirrors the kernel's per-lane
Golomb-k helper.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _cuda

BIG = 1 << 28
U32 = 0xFFFFFFFF
MAX_ENB = 64 * 64 + 1     # M + 1 for W = 64; csrc/decide_modes.cu kMaxEnb
ROUND = 32                # tiles per window: one lane each
# K2's guard: a round committing fewer than GUARD tiles is short; after
# SHORT_ROUNDS short rounds in a row, up to BURST tiles of the window are
# decided serially (csrc/decide_modes.cu: the `guard` argument, kShortRounds,
# kBurst)
GUARD = 2
SHORT_ROUNDS = 2
BURST = 32


def mode_costs(codec_id: int):
    """(use_pred, match header bits, nomatch header bits) of a codec."""
    use_pred = codec_id in (7, 8)
    mcost = 1 + (1 if use_pred else 0) + (1 if codec_id == 8 else 0)
    ncost = 2 if use_pred else 1
    return use_pred, mcost, ncost


def idx_len(n_cands: torch.Tensor) -> torch.Tensor:
    """A match's rank width, integer-exact: max(1, (n-1).bit_length()) for
    n > 0 candidates, else 0 (a float log2 could widen it at powers of 2)."""
    n1 = torch.clamp(n_cands.to(torch.int64), min=1) - 1
    ks = 1 << torch.arange(31, device=n_cands.device, dtype=torch.int64)
    bl = (n1[..., None] >= ks).sum(dim=-1)
    return torch.where(n_cands > 0, torch.clamp(bl, min=1), 0)


def decide_modes_plain(weights4, has_cands, idx_len, enb, *,
                       codec_id: int = 8):
    """Plain PyTorch K2, vectorized over pages and serial over tiles.

    weights4 int32 [B, T, 4]; has_cands, idx_len int32 [B, T]; enb int32
    [M+1].  Returns (mode, weight, k_used), each int32 [B, T]."""
    use_pred, mcost, ncost = mode_costs(codec_id)
    B, T, _ = weights4.shape
    dev = weights4.device
    w4 = weights4.to(torch.int64)
    hc = has_cands != 0
    il = idx_len.to(torch.int64)
    lut = enb.to(torch.int64)
    ks = torch.arange(32, device=dev, dtype=torch.int64)
    # context state: rows 0 = match, 1 = nomatch; (acc, n, k)
    acc = torch.zeros((2, B), dtype=torch.int64, device=dev)
    n = torch.zeros((2, B), dtype=torch.int64, device=dev)
    k = torch.ones((2, B), dtype=torch.int64, device=dev)
    out = torch.empty((B, T, 3), dtype=torch.int64, device=dev)
    bidx = torch.arange(B, device=dev)
    for t in range(T):
        w = w4[:, t]                                              # [B, 4]
        kk = torch.stack([k[0], k[0], k[1], k[1]], dim=1)
        c = kk + (w >> kk) + 1 + lut[w]
        c[:, :2] += mcost + il[:, t, None]
        c[:, 2:] += ncost
        c[:, :2] = torch.where(hc[:, t, None], c[:, :2], BIG)
        if not use_pred:
            c[:, 1] = BIG
            c[:, 3] = BIG
        mode = torch.argmin(c, dim=1)         # first minimum, as np.argmin
        weight = w[bidx, mode]
        ctx = (mode >= 2).to(torch.int64)     # 0 = match context
        out[:, t, 0] = mode
        out[:, t, 1] = weight
        out[:, t, 2] = k[ctx, bidx]
        n2 = (n[ctx, bidx] + 1) & U32
        acc2 = (acc[ctx, bidx] + weight) & U32
        ok = ((n2[:, None] << ks) & U32) >= acc2[:, None]
        k2 = torch.where(ok, ks, 31).amin(dim=1)
        n[ctx, bidx] = n2
        acc[ctx, bidx] = acc2
        k[ctx, bidx] = k2
    out = out.to(torch.int32)
    return out[..., 0], out[..., 1], out[..., 2]


def golomb_k_lane(n: int, acc: int) -> int:
    """The least k in 0..31 with (n << k) mod 2^32 >= acc, else 31, as the
    kernel's ``bic::golomb_k_lane`` finds it: two leading-zero counts and
    one compare, and a short loop only where n << k wraps."""
    n, acc = n & U32, acc & U32
    if acc <= n:
        return 0
    if n == 0:
        return 31
    cn = 32 - n.bit_length()                     # __clz(n)
    k0 = cn - (32 - acc.bit_length())            # acc's top bit over n's
    if (n << k0) & U32 >= acc:
        return k0
    if k0 < cn:
        return k0 + 1
    for k in range(k0 + 1, 32):                  # acc >= 2^31: wraps
        if (n << k) & U32 >= acc:
            return k
    return 31


def _base_costs(w4, hc, il, enb, codec_id):
    """The kernel's per-tile costs without the Golomb terms, int64 [T, 4]:
    header bits + idx_len + 1 + enb[w], or BIG for an absent mode."""
    use_pred, mcost, ncost = mode_costs(codec_id)
    p = 1 + enb[w4]
    p[:, :2] += mcost + il[:, None]
    p[:, 2:] += ncost
    p[:, 0] = np.where(hc, p[:, 0], BIG)
    p[:, 1] = np.where(hc & use_pred, p[:, 1], BIG)
    if not use_pred:
        p[:, 3] = BIG
    return p


def decide_rounds_model(weights4, has_cands, idx_len, enb, *,
                        codec_id: int = 8, guard: int = GUARD):
    """One page through the kernel's order of work, in numpy.

    The tiles go in windows of ROUND, lane s holding tile base + s.  A round
    decides every tile from the window's first undecided one (t0) to its
    end under the contexts' k at t0, sums each context's (n, acc) over the
    round's earlier tiles of that context, and commits up to and including
    the first tile whose update changes its context's k (or to the window's
    end); the next round starts after it.  A round that commits fewer than
    ``guard`` tiles is short; after SHORT_ROUNDS short rounds in a row, up
    to BURST tiles of the window are decided serially, one at a time, and
    then rounds go on.  Returns
    (mode, weight, k_used) int32 [T], the number of rounds and the number
    of tiles decided serially."""
    w4 = np.asarray(weights4, dtype=np.int64)
    hc = np.asarray(has_cands) != 0
    il = np.asarray(idx_len, dtype=np.int64)
    p = _base_costs(w4, hc, il, np.asarray(enb, dtype=np.int64), codec_id)
    T = w4.shape[0]
    out = np.zeros((3, T), dtype=np.int64)
    n, acc, k = [0, 0], [0, 0], [1, 1]          # 0 = match, 1 = nomatch
    rounds = serial = n_short = 0

    def costs(t):
        ks = np.array([k[0], k[0], k[1], k[1]])
        return p[t] + ks + (w4[t] >> ks)

    for base in range(0, T, ROUND):
        end = min(base + ROUND, T)
        t0 = base
        while t0 < end:
            rounds += 1
            ts = np.arange(t0, end)
            mode = costs(ts).argmin(axis=1)        # first minimum
            wt = w4[ts, mode]
            ctx = (mode >= 2).astype(np.int64)
            cnt = np.stack([np.cumsum(ctx == c) for c in (0, 1)])
            sm = np.stack([np.cumsum(np.where(ctx == c, wt, 0))
                           for c in (0, 1)])
            own = np.arange(len(ts))
            n_after = (np.take(n, ctx) + cnt[ctx, own]) & U32
            acc_after = (np.take(acc, ctx) + sm[ctx, own]) & U32
            k_new = np.array([golomb_k_lane(int(a), int(b))
                              for a, b in zip(n_after, acc_after)])
            flag = np.flatnonzero(k_new != np.take(k, ctx))
            f = int(flag[0]) if flag.size else len(ts) - 1
            out[0, t0:t0 + f + 1] = mode[:f + 1]
            out[1, t0:t0 + f + 1] = wt[:f + 1]
            out[2, t0:t0 + f + 1] = np.take(k, ctx[:f + 1])
            for c in (0, 1):
                n[c] = (n[c] + int(cnt[c, f])) & U32
                acc[c] = (acc[c] + int(sm[c, f])) & U32
            if flag.size:
                k[ctx[f]] = int(k_new[f])
            t0 += f + 1
            n_short = n_short + 1 if f + 1 < guard else 0
            if n_short >= SHORT_ROUNDS and t0 < end:
                n_short = 0
                stop = min(t0 + BURST, end)
                for t in range(t0, stop):         # the lean serial step
                    m = int(costs(t).argmin())
                    c = int(m >= 2)
                    out[:, t] = (m, w4[t, m], k[c])
                    n[c] = (n[c] + 1) & U32
                    acc[c] = (acc[c] + int(w4[t, m])) & U32
                    k[c] = golomb_k_lane(n[c], acc[c])
                serial += stop - t0
                t0 = stop
    out = out.astype(np.int32)
    return out[0], out[1], out[2], rounds, serial


def decide_modes(weights4, has_cands, idx_len, enb, *, codec_id: int = 8):
    """K2 over a batch of pages: (mode, weight, k_used) int32 [B, T].

    Inputs as ``decide_modes_plain``; ``enb`` is the enumerative-codelength
    LUT enb[w] = ceil(log2 C(M, w))."""
    if weights4.is_cuda:
        return _launch(weights4, has_cands, idx_len, enb, codec_id=codec_id)
    if weights4.device.type == "cpu":
        return decide_modes_plain(weights4, has_cands, idx_len, enb,
                                  codec_id=codec_id)
    raise RuntimeError(f"K2 has no kernel for device {weights4.device}")


def _launch(weights4, has_cands, idx_len, enb, *, codec_id, rounds=None,
            guard: int = GUARD):
    """Launch csrc/decide_modes.cu: one warp per page.  ``rounds``, an
    optional int32 [B] tensor on the same device, receives the number of
    rounds each page's warp took; ``guard`` is the commit size below which
    a round is short (0: rounds only)."""
    B, T, four = weights4.shape
    dev = weights4.device
    checks = [("weights4", weights4, (B, T, 4)),
              ("has_cands", has_cands, (B, T)), ("idx_len", idx_len, (B, T)),
              ("enb", enb, (enb.shape[0],))]
    if rounds is not None:
        checks.append(("rounds", rounds, (B,)))
    for name, t, shape in checks:
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"K2: {name} must be contiguous int32 {shape} "
                             f"on {dev}")
    if four != 4:
        raise ValueError("K2: weights4 must be [B, T, 4]")
    if not 1 <= enb.shape[0] <= MAX_ENB:
        raise ValueError(f"K2: enb has {enb.shape[0]} entries; the kernel "
                         f"takes 1 to {MAX_ENB} (M + 1 for W <= 64)")
    use_pred, mcost, ncost = mode_costs(codec_id)
    out = torch.empty((B, T, 3), dtype=torch.int32, device=dev)
    lib = _cuda.get_lib()
    _cuda.check(lib.bic_decide_modes(
        ctypes.c_void_p(weights4.data_ptr()),
        ctypes.c_void_p(has_cands.data_ptr()),
        ctypes.c_void_p(idx_len.data_ptr()), ctypes.c_void_p(enb.data_ptr()),
        ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(None if rounds is None else rounds.data_ptr()),
        B, T, enb.shape[0], int(use_pred), mcost, ncost, guard,
        _cuda.stream(dev)), "bic_decide_modes")
    _cuda.launches["decide_modes"] += 1
    return out[..., 0], out[..., 1], out[..., 2]
