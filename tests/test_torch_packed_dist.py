"""Plain K5 and K6 (the port's packed Hamming distances and row weights)
against the JAX package's Pallas kernels in interpret mode, exact; the
wrappers' dispatch on the tensor's device."""

import numpy as np
import pytest
import torch

from binary_image_compression_tpu.ops import bitpack as jbp
from binary_image_compression_tpu.ops import pallas_kernels as pk
from binary_image_compression_tpu_torch.ops import _cuda, packed_dist


def _words(bits):
    return torch.from_numpy(jbp.np_pack(bits).view(np.int32))


@pytest.mark.parametrize("n,k,m,block_n", [
    (77, 33, 130, 256),    # tests/test_pallas.py shapes
    (300, 16, 64, 128),    # several row blocks on the JAX side
    (1, 1, 1, 256),        # one word, one bit
    (33, 65, 32, 256),     # N and K not multiples of 32
    (64, 40, 2080, 256)])  # wider than JAX's packed BSVD route takes
def test_k5_plain_matches_jax(n, k, m, block_n):
    rng = np.random.RandomState(n + k + m)
    a = rng.rand(n, m) < 0.4
    b = rng.rand(k, m) < 0.6
    want = np.asarray(pk.packed_dist_matrix(jbp.np_pack(a), jbp.np_pack(b),
                                            block_n=block_n))
    got = packed_dist.packed_dist_matrix(_words(a), _words(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, (a[:, None] ^ b[None]).sum(-1))


def test_k5_plain_chunks_rows(monkeypatch):
    """The plain K5 walks N in chunks sized by its temporary's budget."""
    rng = np.random.RandomState(3)
    a, b = rng.rand(50, 96) < 0.5, rng.rand(7, 96) < 0.5
    monkeypatch.setattr(packed_dist, "_PLAIN_CHUNK", 7 * 3 * 4)
    got = packed_dist.packed_dist_matrix_plain(_words(a), _words(b))
    want = np.asarray(pk.packed_dist_matrix(jbp.np_pack(a), jbp.np_pack(b)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,m", [(200, 257), (1, 1), (5, 2048)])
def test_k6_plain_matches_jax(n, m):
    a = np.random.RandomState(n + m).rand(n, m) < 0.3
    want = np.asarray(pk.packed_row_weight(jbp.np_pack(a)))
    got = packed_dist.packed_row_weight(_words(a))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, a.sum(1))


def test_wrappers_take_plain_on_cpu_and_raise_elsewhere():
    a = torch.zeros((4, 2), dtype=torch.int32)
    before = dict(_cuda.launches)
    assert torch.equal(packed_dist.packed_dist_matrix(a, a),
                       torch.zeros((4, 4), dtype=torch.int32))
    assert torch.equal(packed_dist.packed_row_weight(a),
                       torch.zeros(4, dtype=torch.int32))
    assert dict(_cuda.launches) == before   # the plain versions count nothing
    meta = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        packed_dist.packed_dist_matrix(meta, meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        packed_dist.packed_row_weight(meta)
    with pytest.raises(ValueError, match="int32"):
        packed_dist.packed_row_weight(a.to(torch.int64))
    with pytest.raises(ValueError, match="same number of words"):
        packed_dist.packed_dist_matrix(a, torch.zeros((3, 1),
                                                      dtype=torch.int32))
