"""Kernels K5 and K6 (Hamming distances and weights of packed bit rows) and
the BSVD pursuit kernel that fuses them.

Counterparts of ``packed_dist_matrix`` (:45, kernel body ``_dist_kernel``
:21) and ``packed_row_weight`` (:728, ``_weight_kernel`` :722) in
``binary_image_compression_tpu/ops/pallas_kernels.py``.  Rows are int32
tensors of 32-bit words holding the uint32 bit patterns of
``bitpack.pack`` (``bitpack.to_i32``).

``packed_pursuit`` is the BSVD pursuit (``models/bsvd.update_coefficients``,
packed route) in one launch: each row walks its own loop of distance
passes and flips to its end, with its first |E_i| (K6's work) fused in
(``csrc/packed_pursuit.cuh``, note at its top).  Its plain version is the
sweep loop the JAX package runs, over the plain K5 and K6.  K5 stays the op
of ``bsvd.distances_to_atoms`` and K6 the row weights; neither runs in the
pursuit.

``packed_dist_matrix``, ``packed_row_weight`` and ``packed_pursuit`` launch
``csrc/packed_dist.cu`` for CUDA tensors and run the ``*_plain`` versions
for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda, bitpack

# elements of the plain K5's [n, K, Wd] int64 temporary per chunk (64 MB)
_PLAIN_CHUNK = 8 * 1024 * 1024


def packed_dist_matrix_plain(a, b):
    """Plain PyTorch K5: int32 [N, Wd] x int32 [K, Wd] -> int32 [N, K].

    SWAR popcount on int64, in chunks of rows so that the [n, K, Wd]
    temporary stays under 64 MB."""
    a64, b64 = bitpack.from_i32(a), bitpack.from_i32(b)
    N, Wd = a.shape
    K = b.shape[0]
    out = torch.empty((N, K), dtype=torch.int32, device=a.device)
    n = max(1, _PLAIN_CHUNK // max(1, K * Wd))
    for s in range(0, N, n):
        x = a64[s:s + n, None, :] ^ b64[None, :, :]
        out[s:s + n] = bitpack.popcount(x).sum(dim=-1).to(torch.int32)
    return out


def packed_row_weight_plain(a):
    """Plain PyTorch K6: int32 [N, Wd] -> int32 [N] row popcounts."""
    return bitpack.popcount(bitpack.from_i32(a)).sum(dim=-1).to(torch.int32)


def _check(*ts):
    for t in ts:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] < 1:
            raise ValueError("K5/K6 take int32 [rows, words >= 1] tensors")
    if any(t.shape[1] != ts[0].shape[1] for t in ts):
        raise ValueError("K5: a and b must have the same number of words")
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("K5: a and b must be on the same device")


def packed_dist_matrix(a, b):
    """K5: all-pairs Hamming distances, int32 [N, Wd] x [K, Wd] ->
    int32 [N, K]."""
    _check(a, b)
    if a.is_cuda:
        return _launch_dist(a, b)
    if a.device.type == "cpu":
        return packed_dist_matrix_plain(a, b)
    raise RuntimeError(f"K5 has no kernel for device {a.device}")


def packed_row_weight(a):
    """K6: row weights, int32 [N, Wd] -> int32 [N]."""
    _check(a)
    if a.is_cuda:
        return _launch_weight(a)
    if a.device.type == "cpu":
        return packed_row_weight_plain(a)
    raise RuntimeError(f"K6 has no kernel for device {a.device}")


def _check_pursuit(Ep, Dp, A):
    _check(Ep, Dp)
    if A.dtype != torch.int8 or A.shape != (Ep.shape[0], Dp.shape[0]):
        raise ValueError("pursuit: A must be int8 [N, K] for Ep [N, nw] and "
                         "Dp [K, nw]")
    if Dp.shape[0] < 1:
        raise ValueError("pursuit: Dp needs at least one atom")
    if A.device != Ep.device:
        raise ValueError("pursuit: A must be on Ep's device")
    if not (Ep.is_contiguous() and A.is_contiguous()):
        raise ValueError("pursuit: Ep and A are updated in place and must be "
                         "contiguous")


def sweeps(Ep, Dp, A, max_flips: int, dist, weight):
    """The JAX package's sweep loop on packed rows: K6 (`weight`) for the
    first |E_i|, then per sweep K5 (`dist`) for d[i, k] = |E_i ^ D_k|, the
    first minimum, and a flip of it in every still-improving row, until no
    row improves or `max_flips` sweeps ran.  |E_i| is carried: a flip makes
    it the chosen distance.  Updates Ep and A in place; returns (changed
    int64, passes int32 [N]), passes[i] counting the sweeps row i was
    active in.  One host sync per sweep."""
    N, K = A.shape
    w = weight(Ep)
    ks = torch.arange(K, device=Ep.device)
    active = torch.ones((N,), dtype=torch.bool, device=Ep.device)
    changed = torch.zeros((N,), dtype=torch.bool, device=Ep.device)
    passes = torch.zeros((N,), dtype=torch.int32, device=Ep.device)
    it = 0
    while it < max_flips and bool(active.any()):
        passes += active
        d = dist(Ep, Dp)
        bestk = torch.argmin(d, dim=1)
        bestd = d.gather(1, bestk[:, None])[:, 0]
        improve = (bestd < w) & active
        A ^= (bestk[:, None] == ks[None, :]).to(A.dtype) * improve[:, None]
        Ep ^= Dp[bestk] * improve[:, None]
        w = torch.where(improve, bestd, w)
        changed |= improve
        active = improve
        it += 1
    return changed.sum(), passes


def packed_pursuit_plain(Ep, Dp, A, max_flips: int):
    """Plain PyTorch pursuit: ``sweeps`` over the plain K5 and K6."""
    return sweeps(Ep, Dp, A, max_flips, packed_dist_matrix_plain,
                  packed_row_weight_plain)


def packed_pursuit(Ep, Dp, A, max_flips: int):
    """The BSVD pursuit on packed rows: Ep int32 [N, nw] and A int8 [N, K]
    updated in place against Dp int32 [K, nw], at most `max_flips` flips a
    row.  Returns (changed, passes): the rows that changed (int64, 0-dim)
    and each row's distance passes (int32 [N]), the same on both routes."""
    _check_pursuit(Ep, Dp, A)
    if Ep.is_cuda:
        return _launch_pursuit(Ep, Dp, A, max_flips)
    if Ep.device.type == "cpu":
        return packed_pursuit_plain(Ep, Dp, A, max_flips)
    raise RuntimeError(f"the pursuit has no kernel for device {Ep.device}")


def _launch_dist(a, b):
    """Launch K5: one block per 32 x 32 output tile."""
    a, b = a.contiguous(), b.contiguous()
    N, Wd = a.shape
    K = b.shape[0]
    out = torch.empty((N, K), dtype=torch.int32, device=a.device)
    if N == 0 or K == 0:
        return out
    lib = _cuda.get_lib()
    _cuda.check(lib.bic_packed_dist_matrix(
        ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(b.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), N, K, Wd, _cuda.stream(a.device)),
        "bic_packed_dist_matrix")
    _cuda.launches["packed_dist_matrix"] += 1
    return out


def _launch_weight(a):
    """Launch K6: one warp per row."""
    a = a.contiguous()
    N, Wd = a.shape
    out = torch.empty((N,), dtype=torch.int32, device=a.device)
    if N == 0:
        return out
    lib = _cuda.get_lib()
    _cuda.check(lib.bic_packed_row_weight(
        ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(out.data_ptr()), N, Wd,
        _cuda.stream(a.device)), "bic_packed_row_weight")
    _cuda.launches["packed_row_weight"] += 1
    return out


def _launch_pursuit(Ep, Dp, A, max_flips: int, stage: int = -1):
    """Launch the pursuit kernel: one warp per row, persistent.  `stage`:
    1 stages D in shared memory, 0 reads it from device memory, -1 chooses
    by its size (the kernel's checks force each)."""
    N, nw = Ep.shape
    Dp = Dp.contiguous()
    passes = torch.empty((N,), dtype=torch.int32, device=Ep.device)
    ctr = torch.empty((2,), dtype=torch.int64, device=Ep.device)
    if N == 0:
        return ctr[1].zero_(), passes
    lib = _cuda.get_lib()
    _cuda.check(lib.bic_packed_pursuit(
        *(ctypes.c_void_p(t.data_ptr()) for t in (Ep, Dp, A, passes, ctr)),
        N, Dp.shape[0], nw, max(0, min(int(max_flips), 2 ** 31 - 1)), stage,
        _cuda.stream(Ep.device)), "bic_packed_pursuit")
    _cuda.launches["packed_pursuit"] += 1
    return ctr[1], passes
