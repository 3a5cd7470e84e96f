"""The arithmetic of K7's design (``csrc/rans_encode.cu``) on the CPU:
``div_magic``'s divisor constants, the kernel's step as it uses them, and
the stream-order pass's plain twin ``stream_order_plain`` against
``pack_varlen`` of the plain loop's words and flags."""

import numpy as np
import pytest
import torch

from binary_image_compression_tpu_torch.models import compress
from binary_image_compression_tpu_torch.ops import ransdevice as rd
from chip_smoke import K7_RANDOM

F_ALL = np.arange(1, rd.PSCALE + 1)


@pytest.fixture(scope="module")
def magic():
    return rd.div_magic(F_ALL)


def test_div_magic_exact_by_its_error_bound(magic):
    """For every f and every y < f * (2^20 + 1) (every state before the
    divide, x < f * 2^20, plus bit * f), floor((y + a) m / 2^k) == y // f.
    With y = q f + r:
    round-up (a = 0, e = m f - 2^k >= 0): y m / 2^k = q + (r + y e / 2^k) / f,
    exact iff r + y e / 2^k < f for all y, i.e. y_max e < 2^k (y_max has
    r = f - 1);
    round-down (a = 1, e = 2^k - m f > 0): (y + 1) m / 2^k = q + (r + 1 -
    (y + 1) e / 2^k) / f, exact iff (y + 1) e <= 2^k at r = 0, the largest
    such y being 2^20 f."""
    for f, (m, s, a) in zip(F_ALL.tolist(), magic.tolist()):
        k = 32 + s
        assert 0 < m < 1 << 32 and 0 <= s < 32 and a in (0, 1)
        y_max = f * ((1 << 20) + 1) - 1
        if a == 0:
            e = m * f - (1 << k)
            assert e >= 0 and y_max * e < 1 << k, f
        else:
            e = (1 << k) - m * f
            assert e > 0 and ((1 << 20) * f + 1) * e <= 1 << k, f


def test_div_magic_matches_floor_division(magic):
    rs = np.random.RandomState(11)
    f = np.repeat(F_ALL, 24).astype(np.uint64)
    lim = f << np.uint64(20)                       # x < f * 2^20
    x = (rs.randint(0, 1 << 62, f.size).astype(np.uint64) % lim)
    x[0::24], x[1::24], x[2::24] = 0, f[1::24] - 1, lim[2::24] - 1
    x[3::24] = lim[3::24] - f[3::24]
    m, s, a = (np.repeat(magic[:, i], 24).astype(np.uint64)
               for i in range(3))
    for bit in (0, 1):
        y = x + np.uint64(bit) * f
        q = ((y + a) * m) >> (np.uint64(32) + s)
        np.testing.assert_array_equal(q, y // f)


def _kernel_steps(f, b, x, magic):
    """The kernel's step on uint64 arrays, from the record the producers
    write ({d*m, m, w = (f - 1) << 20 | s}, d = a + bit*f; a pad is
    {0, 0, 4095 << 20})."""
    pad = f == rd.PSCALE
    m, s, a = (np.where(pad, 0, magic[f - 1, i]).astype(np.uint64)
               for i in range(3))
    bit = (b != 0).astype(np.uint64)
    dm = (a + bit * f) * m
    w = (f - np.uint64(1)) << np.uint64(20) | s
    thr = w | np.uint64(0xFFFFF)
    c = np.uint64(4095) - (w >> np.uint64(20))
    need = x > thr
    xs = np.where(need, x >> np.uint64(16), x)
    q = ((xs * m + dm) >> np.uint64(32)) >> (w & np.uint64(31))
    return need, q * c + xs


def test_kernel_step_matches_the_plain_step(magic):
    """need, the renormalised state and the next state equal the reference
    step for random states and every (p1, bit), pads included."""
    rs = np.random.RandomState(5)
    p1 = np.repeat(np.arange(1, rd.PSCALE), 16)
    bit = rs.randint(0, 2, p1.size)
    f = np.where(bit == 1, p1, rd.PSCALE - p1)
    b = np.where(bit == 1, rd.PSCALE - p1, 0)
    f = np.concatenate([f, np.full(64, rd.PSCALE)])
    b = np.concatenate([b, np.zeros(64, int)])
    x = rs.randint(1 << 16, 1 << 32, f.size, dtype=np.uint64)
    x[:4] = (1 << 32) - 1, 1 << 16, (f[2] << 20) - 1, f[3] << 20
    need, got = _kernel_steps(f.astype(np.uint64), b, x, magic)
    f64, x64 = f.astype(np.int64), x.astype(np.int64)
    want_need = (x64 >> 20) >= f64
    xs = np.where(want_need, x64 >> 16, x64)
    want = ((xs // f64) << 12) + xs % f64 + b
    np.testing.assert_array_equal(need, want_need)
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_transpose32_plain_transposes():
    rs = np.random.RandomState(3)
    x = rs.randint(0, 1 << 32, (5, 32), dtype=np.int64)
    got = rd.transpose32_plain(torch.from_numpy(x)).numpy()
    bits = (x[:, :, None] >> np.arange(32)) & 1          # [n, j, u]
    want = (bits.transpose(0, 2, 1) << np.arange(32)).sum(-1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "rows,cols,sr,nl",
    K7_RANDOM + [(64, 64, 32, nl) for nl in (1, 4, 8, 33, 64, 255)])
def test_stream_order_twin_matches_pack_varlen(rows, cols, sr, nl):
    """``rans_stripes_twin`` (the plain loop's words and flags through the
    kernel's stream-order pass) == ``rans_stripes_plain`` (through
    ``pack_varlen``), on chip_smoke's random-table geometries."""
    rs = np.random.RandomState(rows * cols + nl)
    bits = torch.from_numpy(rs.rand(2, rows, cols) < 0.3)
    ctx = torch.stack([compress.scab_ctx_map(b, tmpl=12, stripe_rows=sr)
                       for b in bits])
    p_used = torch.from_numpy(rs.randint(1, 4096, (2, 4096)))
    kw = dict(stripe_rows=sr, n_lanes=nl)
    want = rd.rans_stripes_plain(bits, ctx, p_used, **kw)
    got = rd.rans_stripes_twin(bits, ctx, p_used, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_step_flag_words_pack_32_steps_per_lane():
    rs = np.random.RandomState(9)
    flags = torch.from_numpy(rs.rand(70, 3, 33) < 0.4)
    fw = rd.step_flag_words(flags)
    assert fw.shape == (3, 3, 64)
    t, s, l = 37, 2, 32
    assert (int(fw[s, t // 32, l]) >> (t % 32) & 1) == int(flags[t, s, l])
    got = (fw[..., None] >> torch.arange(32)) & 1         # [S, G, Np, u]
    back = got.permute(1, 3, 0, 2).reshape(96, 3, 64)
    assert torch.equal(back[:70, :, :33].bool(), flags)
    assert not back[70:].any() and not back[:, :, 33:].any()
