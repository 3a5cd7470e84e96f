"""The port's numpy windowed decoder (models/codec._decode_windowed) against
the native decoder and the JAX package's numpy decoder, and the route
``codec.decode`` takes on either side of the native decoder's 2^30-pixel
bound."""

import os

import numpy as np
import pytest

from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu.ops import bitstream as jbitstream
from binary_image_compression_tpu_torch import native
from binary_image_compression_tpu_torch.models import codec
from binary_image_compression_tpu_torch.ops.bitstream import BitReader
from binary_image_compression_tpu_torch.utils import pnm

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _stream(img, codec_id, strict, W, R):
    p = codec.CodecParams(codec=codec_id, W=W, R=R, strict=strict)
    hdr = codec._header(p, *img.shape, codec.image_crc(img))
    return native.encode_windowed(img, hdr, codec_id, strict, W,
                                  p.resolved_T(), R)


@pytest.mark.parametrize("fixture", ["text64.pbm", "ragged75x101.pbm"])
@pytest.mark.parametrize("W", [8, 16, 32])
@pytest.mark.parametrize("strict", [False, True], ids=["causal", "strict"])
@pytest.mark.parametrize("codec_id", [4, 6, 7, 8])
def test_numpy_decoder_matches_native(codec_id, strict, W, fixture):
    img = pnm.read_pbm(os.path.join(FIX, fixture))
    rows, cols = img.shape
    R = 2 * W
    blob = _stream(img, codec_id, strict, W, R)
    want = native.decode_windowed(blob, rows, cols)
    np.testing.assert_array_equal(want, img)
    got = codec._decode_windowed(
        BitReader(blob, bit_offset=codec.HEADER_LEN * 8), codec_id, W, rows,
        cols, R, strict)
    np.testing.assert_array_equal(got, want)
    ref = jcodec._decode_windowed(
        jbitstream.BitReader(blob, bit_offset=jcodec.HEADER_LEN * 8),
        codec_id, W, rows, cols, 0, R, strict)
    np.testing.assert_array_equal(got, ref)


def test_window_candidates_match_jax():
    for i0, j0, W, R, cols in ((0, 0, 8, 16, 64), (16, 8, 8, 16, 64),
                               (48, 96, 16, 32, 101), (64, 0, 16, 128, 512),
                               (32, 480, 32, 64, 512)):
        assert (codec.window_candidates(i0, j0, W, R, cols)
                == jcodec.window_candidates(i0, j0, W, R, 10 ** 6, cols))


def _header_only(rows, cols, *, codec_id=8, strict=False, W=16, R=128):
    """A BIC1 header declaring rows x cols and a few payload bytes: enough
    to route, never decoded here."""
    p = codec.CodecParams(codec=codec_id, W=W, R=R, strict=strict)
    return codec._header(p, rows, cols, 0) + b"\0" * 16


def test_pages_past_the_native_bound_take_the_numpy_route(monkeypatch):
    rows, cols = 32768, 32769
    assert codec.NATIVE_MAX_PIXELS < rows * cols <= codec.MAX_PIXELS
    seen = []
    sentinel = np.zeros((1, 1), dtype=bool)

    def spy(r, codec_id, W, rows_, cols_, R, strict):
        assert isinstance(r, BitReader)
        seen.append((codec_id, W, rows_, cols_, R, strict))
        return sentinel

    def refuse(*a, **k):
        raise AssertionError("the native decoder was called past its bound")

    monkeypatch.setattr(codec, "_decode_windowed", spy)
    monkeypatch.setattr(codec.native, "decode_windowed", refuse)
    blob = _header_only(rows, cols, codec_id=8, strict=True, W=16, R=128)
    assert codec.decode(blob, verify_crc=False) is sentinel
    assert seen == [(8, 16, rows, cols, 128, True)]


def test_pages_at_the_native_bound_take_the_native_route(monkeypatch):
    seen = []
    sentinel = np.zeros((1, 1), dtype=bool)

    def spy(blob, rows, cols):
        seen.append((len(blob), rows, cols))
        return sentinel

    def refuse(*a, **k):
        raise AssertionError("the numpy decoder was called within the bound")

    monkeypatch.setattr(codec.native, "decode_windowed", spy)
    monkeypatch.setattr(codec, "_decode_windowed", refuse)
    for rows, cols in ((32768, 32768), (1, 2 ** 30), (512, 512)):
        assert rows * cols <= codec.NATIVE_MAX_PIXELS
        blob = _header_only(rows, cols, codec_id=7)
        assert codec.decode(blob, verify_crc=False) is sentinel
        assert seen[-1] == (len(blob), rows, cols)

