"""Kernel K2: per-tile mode decision with two adaptive Golomb contexts.

Counterpart of ``binary_image_compression_tpu/ops/pallas_decide.py``
(``decide_modes``).  Per tile, in raster order, the cheapest of up to four
codings {match, nomatch} x {nonpred, pred} wins (first minimum on ties), and
the chosen weight updates that mode's Golomb context (GolombCoder.cpp:29-33,
32-bit unsigned wraparound, k starting at 1).  The chain is serial over the
tiles of a page; pages are independent.

``decide_modes`` launches ``csrc/decide_modes.cu`` for CUDA tensors and
runs ``decide_modes_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

BIG = 1 << 28
U32 = 0xFFFFFFFF
MAX_ENB = 64 * 64 + 1     # M + 1 for W = 64; csrc/decide_modes.cu kMaxEnb


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


def _launch(weights4, has_cands, idx_len, enb, *, codec_id):
    """Launch csrc/decide_modes.cu: one warp per page."""
    B, T, four = weights4.shape
    dev = weights4.device
    for name, t, shape in (("weights4", weights4, (B, T, 4)),
                           ("has_cands", has_cands, (B, T)),
                           ("idx_len", idx_len, (B, T)),
                           ("enb", enb, (enb.shape[0],))):
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
        ctypes.c_void_p(out.data_ptr()), B, T, enb.shape[0], int(use_pred),
        mcost, ncost, _cuda.stream(dev)), "bic_decide_modes")
    _cuda.launches["decide_modes"] += 1
    return out[..., 0], out[..., 1], out[..., 2]
