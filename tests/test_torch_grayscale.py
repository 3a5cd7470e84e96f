"""Grayscale and color in the port against the JAX package, on the CPU,
exactly: PGM/PPM IO, ``encode_pgm`` in its four backends (the port's names
for JAX's host, tpu, tpu-device-assembly and tpu-rans), ``encode_ppm``,
each package decoding the other's streams, 16-bit pages, codec 10 on PBM
pages through ``codec.encode`` and an archive, and the batched codec-13
stack against one page at a time."""

import io
import os

import numpy as np
import pytest
import torch

from binary_image_compression_tpu.models import archive as jarchive
from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu.utils import pnm as jpnm
from binary_image_compression_tpu_torch.models import archive, codec, compress
from binary_image_compression_tpu_torch.ops import ransdevice
from binary_image_compression_tpu_torch.utils import bitplanes, pnm

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
# the port's backend -> JAX's
BACKENDS = {"host": "host", "device": "tpu",
            "device-assembly": "tpu-device-assembly",
            "device-rans": "tpu-rans"}


def cumsum_page(rows=64, cols=96, seed=9, maxval=255):
    """JAX tests/test_compress_tpu.py:222's smooth 8-bit page, or its
    values scaled to `maxval`."""
    rng = np.random.RandomState(seed)
    v = np.abs(np.cumsum(rng.randn(rows, cols), axis=1)) * 9
    return (v * (maxval // 255) + rng.randint(0, max(1, maxval // 255),
                                             (rows, cols))).astype(
        np.uint32) % (maxval + 1)


def p10():
    return (codec.CodecParams(codec=10, W=0, T=0, R=0),
            jcodec.CodecParams(codec=10, W=0, T=0, R=0))


@pytest.fixture(scope="module")
def jax_streams():
    """JAX's encode_pgm of the 64 x 96 page in every backend, with no
    params and with codec 10 (one compile per device backend, shared)."""
    gray = cumsum_page()
    out = {}
    for be, jbe in BACKENDS.items():
        out[be, None] = jcodec.encode_pgm(gray, 255, backend=jbe)
        out[be, 10] = jcodec.encode_pgm(gray, 255, p10()[1], backend=jbe)
    return gray, out


@pytest.mark.parametrize("with_params", [False, True])
@pytest.mark.parametrize("backend", list(BACKENDS))
def test_encode_pgm_equals_jax(jax_streams, backend, with_params):
    gray, want = jax_streams
    params = p10()[0] if with_params else None
    got = codec.encode_pgm(gray, 255, params, backend=backend, device="cpu")
    assert got == want[backend, 10 if with_params else None]
    g, m = codec.decode_pgm(got)
    np.testing.assert_array_equal(g, gray)
    assert m == 255
    g, m = jcodec.decode_pgm(got)
    np.testing.assert_array_equal(g, gray)


def test_codec10_backends_agree_and_decode_jax(jax_streams):
    """codec 10 gives one stream in the three codec-10 routes, and the
    port decodes each of JAX's streams."""
    gray, want = jax_streams
    assert want["host", 10] == want["device", 10] == \
        want["device-assembly", 10] == want["device-assembly", None]
    for blob in want.values():
        g, m = codec.decode_pgm(blob)
        np.testing.assert_array_equal(g, gray)


@pytest.mark.parametrize("backend", ["host", "device", "device-rans"])
def test_gray64_fixture_equals_jax(backend):
    gray, maxval = pnm.read_pnm(os.path.join(FIX, "gray64.pgm"))
    jg, jm = jpnm.read_pnm(os.path.join(FIX, "gray64.pgm"))
    np.testing.assert_array_equal(gray, jg)
    assert maxval == jm
    got = codec.encode_pgm(gray, maxval, backend=backend, device="cpu")
    assert got == jcodec.encode_pgm(gray, maxval, backend=BACKENDS[backend])
    if backend == "device":
        # codec 10's device routes against JAX's host codec-10 stream
        want = jcodec.encode_pgm(gray, maxval, p10()[1])
        for be in ("device", "device-assembly"):
            assert codec.encode_pgm(gray, maxval, p10()[0], backend=be,
                                    device="cpu") == want
    np.testing.assert_array_equal(jcodec.decode_pgm(got)[0], gray)


@pytest.mark.parametrize("maxval", [4095, 65535])
def test_16bit_round_trips(maxval):
    """16-bit pages at 12 and 16 planes, in every backend: the stream
    decodes in both packages, the host streams equal JAX's, with and
    without the gray code, and the PGM file round-trips byte for byte."""
    gray = cumsum_page(48, 40, seed=maxval, maxval=maxval)
    assert gray.max() > 255
    want = jcodec.encode_pgm(gray, maxval)
    assert codec.encode_pgm(gray, maxval, device="cpu") == want
    assert codec.encode_pgm(gray, maxval, gray_code=False, device="cpu") == \
        jcodec.encode_pgm(gray, maxval, gray_code=False)
    ref10 = jcodec.encode_pgm(gray, maxval, p10()[1])
    for be in BACKENDS:
        params = p10()[0] if be != "device-rans" else None
        blob = codec.encode_pgm(gray, maxval, params, backend=be,
                                device="cpu")
        if be != "device-rans":
            assert blob == ref10
        assert blob[4] == bitplanes.nplanes_for_maxval(maxval)
        for dec in (codec.decode_pgm, jcodec.decode_pgm):
            g, m = dec(blob)
            np.testing.assert_array_equal(g, gray)
            assert m == maxval
    f1, f2 = io.BytesIO(), io.BytesIO()
    pnm.write_pgm(gray, maxval, f1)
    jpnm.write_pgm(gray, maxval, f2)
    assert f1.getvalue() == f2.getvalue()
    back, m = pnm.read_pnm(io.BytesIO(f1.getvalue()))
    np.testing.assert_array_equal(back, gray)


def test_ascii_pgm_matches_jax():
    gray = cumsum_page(5, 9)
    f1, f2 = io.BytesIO(), io.BytesIO()
    pnm.write_pgm(gray, 255, f1, binary=False)
    jpnm.write_pgm(gray, 255, f2, binary=False)
    assert f1.getvalue() == f2.getvalue()
    np.testing.assert_array_equal(pnm.read_pnm(io.BytesIO(f1.getvalue()))[0],
                                  gray)


@pytest.mark.parametrize("backend", ["host", "device", "device-rans"])
def test_encode_ppm_equals_jax(jax_streams, backend):
    """A color page from three 64 x 96 channels (JAX's jits for that shape
    are warm): the port's BICC == JAX's, and each decodes the other's."""
    r = cumsum_page(seed=1)
    g = cumsum_page(seed=2)
    b = cumsum_page(seed=3)
    rgb = (r << 16) | (g << 8) | b
    got = codec.encode_ppm(rgb, 255, backend=backend, device="cpu")
    want = jcodec.encode_ppm(rgb, 255, backend=BACKENDS[backend])
    assert got == want
    for dec in (codec.decode_ppm, jcodec.decode_ppm):
        back, m = dec(got)
        np.testing.assert_array_equal(back, rgb)
        assert m == 255
    f1, f2 = io.BytesIO(), io.BytesIO()
    pnm.write_ppm(rgb, 255, f1)
    jpnm.write_ppm(rgb, 255, f2)
    assert f1.getvalue() == f2.getvalue()
    np.testing.assert_array_equal(pnm.read_pnm(io.BytesIO(f1.getvalue()))[0],
                                  rgb)


@pytest.mark.parametrize("name", ["text64.pbm", "ragged75x101.pbm",
                                  "sparse128.pbm", "noise96x80.pbm"])
def test_codec10_pbm_equals_jax(name):
    img = pnm.read_pbm(os.path.join(FIX, name))
    got = codec.encode(img, p10()[0])
    assert got == jcodec.encode(img, p10()[1])
    np.testing.assert_array_equal(codec.decode(got), img)
    np.testing.assert_array_equal(jcodec.decode(got), img)


def test_codec10_archive_equals_jax():
    pages = [pnm.read_pbm(os.path.join(FIX, n))
             for n in ("text64.pbm", "ragged75x101.pbm", "text64.pbm")]
    got = archive.encode_archive(pages, p10()[0], device="cpu")
    assert got == jarchive.encode_archive(pages, p10()[1])
    for i, page in enumerate(pages):
        np.testing.assert_array_equal(archive.decode_page(got, i), page)


def test_codec10_rejects_a_corrupt_payload():
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    blob = codec.encode(img, p10()[0])
    with pytest.raises(ValueError):
        codec.decode(blob[:codec.HEADER_LEN + 3])


def test_rans_stack_equals_one_page_at_a_time():
    """The stack's counts, tables and K7 batch == rans_page_encode of each
    plane, field by field."""
    planes = bitplanes.decompose(cumsum_page(40, 56, seed=4), 255)
    bits = torch.from_numpy(planes)
    ctx = compress.scab_ctx_map(bits, tmpl=12, stripe_rows=16)
    assert ctx.is_contiguous()          # 40 rows: a short last stripe
    stack = ransdevice.rans_stack_encode(bits, ctx, stripe_rows=16)
    for i in range(planes.shape[0]):
        one = ransdevice.rans_page_encode(bits[i], ctx[i], stripe_rows=16)
        np.testing.assert_array_equal(
            ctx[i].numpy(), compress.scab_ctx_map(bits[i], tmpl=12,
                                                  stripe_rows=16).numpy())
        for k, v in one.items():
            assert torch.equal(stack[k][i], v), k


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        codec.encode_pgm(cumsum_page(4, 4), 255, backend="tpu")
