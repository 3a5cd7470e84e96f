"""Plain K2 (ops/decide) against the JAX device kernel (interpret mode) and
both host replays; the port's GolombCoder and enb LUT against the JAX
package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from binary_image_compression_tpu.models import compress as jcompress
from binary_image_compression_tpu.ops import bitstream as jbs
from binary_image_compression_tpu.ops import entropy as jentropy
from binary_image_compression_tpu.ops import pallas_decide
from binary_image_compression_tpu_torch.models import compress
from binary_image_compression_tpu_torch.ops import decide, entropy


@pytest.mark.parametrize("codec_id", [4, 7, 8])
def test_decide_plain_matches_jax_kernel_and_replays(codec_id):
    M, T, B = 64, 300, 2
    rs = np.random.RandomState(codec_id)
    w4 = rs.randint(0, M + 1, size=(B, T, 4)).astype(np.int32)
    w4[:, :8] = 0                       # ties: first minimum must win
    hc = (rs.rand(B, T) < 0.8).astype(np.int32)
    il = rs.randint(1, 12, size=(B, T)).astype(np.int32)
    enb = torch.from_numpy(compress.enb_lut(M))
    got = decide.decide_modes(torch.from_numpy(w4), torch.from_numpy(hc),
                              torch.from_numpy(il), enb, codec_id=codec_id)
    got = np.stack([g.numpy() for g in got])                  # [3, B, T]
    jenb = jnp.asarray([jbs.enum_nbits(M, w) for w in range(M + 1)],
                       jnp.int32)
    for b in range(B):
        dev = jax.device_get(pallas_decide.decide_modes(
            jnp.asarray(w4[b]), jnp.asarray(hc[b] != 0), jnp.asarray(il[b]),
            jenb, M=M, codec_id=codec_id))
        out = dict(weights4=w4[b], has_cands=hc[b] != 0, idx_len=il[b])
        jhost = jcompress._decide_modes(out, M, codec_id)
        thost = compress._decide_modes(out, M, codec_id)
        for k in range(3):
            np.testing.assert_array_equal(got[k, b], np.asarray(dev[k]))
            np.testing.assert_array_equal(got[k, b], jhost[k])
            np.testing.assert_array_equal(got[k, b], thost[k])


@pytest.mark.parametrize("M", [1, 64, 144, 256, 1024])
def test_enb_lut_matches_jax_enum_nbits(M):
    want = [jbs.enum_nbits(M, w) for w in range(M + 1)]
    np.testing.assert_array_equal(compress.enb_lut(M), want)


def test_golomb_coder_large_u_matches_jax():
    """u up to 2**31 - 1 wraps the 32-bit accumulator and drives k to its
    32 cap; every step's state must match the JAX package's coder."""
    seq = [0, 1, 5, 2 ** 31 - 1, 2 ** 31 - 1, 2 ** 31 - 1, 7, 0, 2 ** 30,
           123456789, 2 ** 31 - 1, 3] + list(range(0, 3000, 97))
    a, b = entropy.GolombCoder(), jentropy.GolombCoder()
    for u in seq:
        assert a.code_sample(u) == b.code_sample(u)
        assert (a.k, a.samples, a.accumulated_error, a.bitcount) == \
            (b.k, b.samples, b.accumulated_error, b.bitcount)
    # no k in 0..31 satisfies (n << k) mod 2^32 >= acc: the search ends at 32
    a = entropy.GolombCoder(samples=1, accumulated_error=2 ** 32 - 1)
    b = jentropy.GolombCoder(samples=1, accumulated_error=2 ** 32 - 1)
    assert a.code_sample(0) == b.code_sample(0) == 2
    assert a.k == b.k == 32


def test_decide_rejects_unknown_device_type():
    t = torch.zeros((1, 4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        decide.decide_modes(t, t[..., 0], t[..., 0], t[0, 0], codec_id=8)


def test_kernel_launcher_bounds_the_enb_lut():
    """The kernel holds enb in shared memory: at most 4097 entries (M + 1
    for W = 64), checked before anything reaches the card."""
    w4 = torch.zeros((1, 4, 4), dtype=torch.int32)
    hc = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="4097"):
        decide._launch(w4, hc, hc, torch.zeros(4098, dtype=torch.int32),
                       codec_id=8)
