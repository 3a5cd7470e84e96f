"""Kernels K5 and K6: Hamming distances and weights of packed bit rows.

Counterparts of ``packed_dist_matrix`` (:45, kernel body ``_dist_kernel``
:21) and ``packed_row_weight`` (:728, ``_weight_kernel`` :722) in
``binary_image_compression_tpu/ops/pallas_kernels.py``.  Rows are int32
tensors of 32-bit words holding the uint32 bit patterns of
``bitpack.pack`` (``bitpack.to_i32``).

The BSVD pursuit (``models/bsvd.update_coefficients``, packed route) runs
them on the packed residual: K6 once per call for every |E_i|, K5 once per
sweep for every |E_i ^ D_k|.

``packed_dist_matrix`` and ``packed_row_weight`` launch
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
