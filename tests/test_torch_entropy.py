"""Port entropy counters and predictor matrices against the JAX package's:
``EGCoder`` (shipped and adaptive), ``golomb_scan``, ``enum_codelength_t``
(JAX's ``enum_codelength_jnp``) and ``predict.predictor_matrices``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.ops import bitpack as jbp
from binary_image_compression_tpu.ops import entropy as jent
from binary_image_compression_tpu.ops import predict as jpred
from binary_image_compression_tpu_torch.ops import bitpack as tbp
from binary_image_compression_tpu_torch.ops import entropy as tent
from binary_image_compression_tpu_torch.ops import predict as tpred


def _runs(seed, n=400):
    """A seeded run stream: lengths with a long tail, about one in five an
    end of line."""
    rs = np.random.RandomState(seed)
    lengths = rs.geometric(0.08, size=n) - 1
    lengths[::37] += rs.randint(100, 5000, size=lengths[::37].shape)
    return [(int(x), bool(e)) for x, e in zip(lengths, rs.rand(n) < 0.2)]


def _eg_state(c):
    return (c.g, c.block_size, c.lut_index, c.bitcount)


@pytest.mark.parametrize("adaptive", [False, True])
def test_eg_coder_matches_jax(adaptive):
    """JAX's cases (tests/test_predict_entropy.py) and a seeded stream: the
    same bits per run and the same state after each."""
    c, j = tent.EGCoder(adaptive=adaptive), jent.EGCoder(adaptive=adaptive)
    for length, eol in [(3, False), (3, False), (4, True), (100, False)] \
            + _runs(7):
        assert c.code_run(length, eol) == j.code_run(length, eol)
        assert _eg_state(c) == _eg_state(j)
    shipped = tent.EGCoder()
    shipped.code_run(3, eol=False)
    assert shipped.bitcount == 5
    grown = tent.EGCoder(adaptive=True)
    grown.code_run(100, eol=False)
    assert grown.bitcount < 100


def _samples(seed):
    """Golomb samples: JAX's test stream, a seeded geometric stream, and
    values past 2**31 whose sums wrap the uint32 state."""
    rs = np.random.RandomState(seed)
    big = rs.randint(2 ** 31, 2 ** 32, size=6, dtype=np.uint64)
    return np.concatenate([[0, 0, 1, 7, 3, 200, 0, 15],
                           rs.geometric(0.05, size=500) - 1, big,
                           np.zeros(40, np.int64)]).astype(np.uint32)


def test_golomb_scan_matches_jax():
    """Lengths and total exact, against JAX's scan and the serial coder
    (which agree until k would be 32: the scan takes 31 there)."""
    x = _samples(5)
    want_lens, want_total = jent.golomb_scan(jnp.asarray(x))
    lens, total = tent.golomb_scan(torch.from_numpy(x.astype(np.int64)))
    assert lens.dtype == total.dtype == torch.int32
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    assert int(total) == int(want_total)
    g = tent.GolombCoder()
    for u in x[:8]:
        g.code_sample(int(u))
    assert int(tent.golomb_scan(x[:8])[1]) == g.bitcount
    # no k < 32 fits after the first sample: the scan takes k = 31
    # (GolombCoder would take 32), so the second sample costs 32 bits
    edge = np.array([3_000_000_000, 5, 0], np.uint32)
    lens = tent.golomb_scan(edge)[0]
    np.testing.assert_array_equal(
        lens.numpy(), np.asarray(jent.golomb_scan(jnp.asarray(edge))[0]))
    assert int(lens[1]) == 32


def test_enum_codelength_t_matches_jax():
    """float32 log2 C(n, r) by lgamma against JAX's, to 1e-6 of the terms it
    differences: |got - want| <= 1e-6 * max(1, (lgamma(n+1) + lgamma(r+1)
    + lgamma(n-r+1)) * log2 e), about 8 float32 ulps of each term.  XLA's
    and torch's float32 lgamma differ by an ulp or more (XLA's lgamma(1) is
    not 0), and the difference of terms near 1e7 (n up to 2**20) turns an
    ulp of a term into bits of the result; so 1e-6 of the result itself
    does not hold.  r == 0 gives exactly 0 in both."""
    rs = np.random.RandomState(3)
    n = rs.randint(1, 1 << 20, size=300)
    n[:40] = rs.randint(1, 300, size=40)
    r = (rs.rand(300) * (n + 1)).astype(np.int64)
    r[:10] = 0
    r[10:20] = n[10:20]
    want = np.asarray(jax.jit(jent.enum_codelength_jnp)(n, r))
    got = tent.enum_codelength_t(torch.from_numpy(n), torch.from_numpy(r))
    assert got.dtype == torch.float32
    terms = np.array([math.lgamma(a + 1) + math.lgamma(b + 1)
                      + math.lgamma(a - b + 1) for a, b in zip(n, r)])
    tol = 1e-6 * np.maximum(1.0, terms * tent.COSMOS_LOG2E)
    assert np.all(np.abs(got.numpy().astype(np.float64) - want) <= tol)
    assert not got[:10].any() and not want[:10].any()
    # scalars, and the host estimator in float64
    assert float(tent.enum_codelength_t(256, 32)) == pytest.approx(
        tent.enum_codelength(256, 32), rel=1e-6)


@pytest.mark.parametrize("M", [1, 25, 64, 100])
def test_predictor_matrices_match_jax(M):
    """D and iD exact; through ``bitpack.mul``, D iD = I and V D (a
    vectorized patch row coded predictively) equals JAX's product."""
    D, iD = tpred.predictor_matrices(M)
    jD, jiD = jpred.predictor_matrices(M)
    np.testing.assert_array_equal(D, jD)
    np.testing.assert_array_equal(iD, jiD)
    assert D.dtype == np.uint32
    tD, tiD = (torch.from_numpy(x.astype(np.int64)) for x in (D, iD))
    eye = tbp.mul(tD, M, False, tiD, M, False)
    np.testing.assert_array_equal(tbp.unpack(eye, M).numpy(), np.eye(M))
    V = jbp.np_pack(np.random.RandomState(M).rand(9, M) < 0.4)
    want = jax.jit(lambda v, d: jbp.mul(v, M, False, d, M, False))(V, jD)
    got = tbp.mul(torch.from_numpy(V.astype(np.int64)), M, False, tD, M,
                  False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
