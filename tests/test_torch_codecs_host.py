"""The port's ``codec.encode`` and ``codec.decode`` for the host codecs (1,
2, 3, the windowed 4/6/7/8 through the native encoder, 12, and codec 11's
reference replay) against the JAX package's, byte for byte, on the test
pages; and the header bounds of the codecs that are new to the port."""

import os
import struct

import numpy as np
import pytest

from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu_torch.models import codec
from binary_image_compression_tpu_torch.utils import pnm

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _page(name):
    if name == "doc512[:128, :128]":
        return pnm.read_pbm(os.path.join(FIX, "doc512.pbm"))[:128, :128]
    return pnm.read_pbm(os.path.join(FIX, name))


PAGES = ["text64.pbm", "text256.pbm", "noise96x80.pbm", "doc512[:128, :128]"]
# (codec, strict): the windowed codecs in both modes, codec 1 in causal
# mode (its strict flag is dropped, checked below), the rest have no mode
CASES = [(c, s) for c in (4, 6, 7, 8) for s in (False, True)] + \
        [(1, False), (2, False), (3, False), (12, False)]


@pytest.mark.parametrize("page,codec_id,strict", [
    (page, c, s) for page in PAGES for c, s in CASES
    # codec 1's host search takes ~4 s on text256: the other pages cover it
    if not (c == 1 and page == "text256.pbm")])
def test_encode_equals_jax_and_decodes_in_both(page, codec_id, strict):
    img = _page(page)
    W = 8 if img.shape[0] <= 96 else 16
    kw = dict(codec=codec_id, W=W, R=32, strict=strict)
    if codec_id == 12:
        kw.update(W=0, T=0)
    blob = codec.encode(img, codec.CodecParams(**kw), device="cpu")
    assert blob == jcodec.encode(img, jcodec.CodecParams(**kw))
    np.testing.assert_array_equal(codec.decode(blob), img)
    np.testing.assert_array_equal(jcodec.decode(blob), img)


def test_codec1_has_no_strict_variant():
    """A strict codec-1 request writes the causal stream (JAX codec.py:286),
    whose flag bit is 0, and codec 1 decodes through the numpy tile loop."""
    img = _page("text64.pbm")
    blob = codec.encode(img, codec.CodecParams(codec=1, W=8, strict=True))
    assert blob == codec.encode(img, codec.CodecParams(codec=1, W=8,
                                                       strict=False))
    assert blob[9] == 0
    assert blob == jcodec.encode(img, jcodec.CodecParams(codec=1, W=8,
                                                         strict=True))


@pytest.mark.parametrize("page,W", [("text64.pbm", 8),
                                    ("noise96x80.pbm", 16),
                                    ("sparse128.pbm", 16)])
def test_codec11_reference_replay_equals_jax(page, W):
    """learn_backend="ref": the rand48 replay is deterministic, so codec
    11's bytes equal JAX's exactly."""
    img = _page(page)
    blob = codec.encode(img, codec.CodecParams(codec=11, W=W),
                        learn_backend="ref")
    assert blob == jcodec.encode(img, jcodec.CodecParams(codec=11, W=W),
                                 learn_backend="ref")
    np.testing.assert_array_equal(codec.decode(blob), img)


@pytest.mark.parametrize("codec_id,W", [(1, 0), (2, 65), (3, 64), (12, 0),
                                        (12, 300), (5, 16), (9, 16),
                                        (14, 0)])
def test_header_bounds_of_the_new_codecs_match_jax(codec_id, W):
    """A header of codec `codec_id` and tile width W is accepted or
    refused as JAX refuses it: unknown ids and, for tiled codecs, W outside
    [1, 64] raise ValueError before any decoder runs."""
    blob = (codec.MAGIC + struct.pack("<IBBHIIII", 0, codec_id, 0, W, 16,
                                      16, 0, 0))

    def verdict(decode):
        try:
            decode(blob)
        except ValueError as e:
            return "corrupt BIC1 header" in str(e)
        except Exception:
            return False
        return False
    assert verdict(codec.decode) == verdict(jcodec.decode)


def test_encode_refuses_what_jax_refuses():
    img = np.zeros((16, 16), dtype=bool)
    for p in (codec.CodecParams(codec=5), codec.CodecParams(codec=9)):
        with pytest.raises(ValueError, match="unknown codec id"):
            codec.encode(img, p)
    for cid in (1, 2, 3, 4, 6, 7, 8):
        with pytest.raises(ValueError, match="out of range"):
            codec.encode(img, codec.CodecParams(codec=cid, W=65))
    # codecs 10, 12 and 13 have no tiles: W is not bounded
    assert codec.encode(img, codec.CodecParams(codec=12, W=300)) == \
        jcodec.encode(img, jcodec.CodecParams(codec=12, W=300))


@pytest.mark.parametrize("codec_id", [2, 4, 12])
def test_encode_pgm_with_host_codecs_equals_jax(codec_id):
    """Grayscale planes under explicit host-codec parameters go through
    ``codec.encode``, as in JAX."""
    gray, maxval = pnm.read_pnm(os.path.join(FIX, "gray64.pgm"))
    kw = dict(codec=codec_id, W=8, R=16, strict=False)
    blob = codec.encode_pgm(gray, maxval, codec.CodecParams(**kw),
                            device="cpu")
    assert blob == jcodec.encode_pgm(gray, maxval, jcodec.CodecParams(**kw))
    np.testing.assert_array_equal(codec.decode_pgm(blob)[0], gray)
