"""``archive.encode_pages`` on every codec the JAX package has beyond the
windowed ones, in both modes: each case writes pages that the port
decodes to the input (every codec's but codec 11's, whose default draw is
the port's own, also equal JAX's and decode in JAX).  The native windowed
encoder refuses other codec ids instead of heading a windowed payload with
them."""

import os

import numpy as np
import pytest

from binary_image_compression_tpu.models import archive as jarchive
from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu_torch.models import archive, codec, compress
from binary_image_compression_tpu_torch.utils import pnm

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("codec_id", [1, 2, 3, 10, 11, 12, 13])
def test_encode_pages_writes_decodable_pages_or_raises(codec_id, strict):
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    pages = [img, np.ascontiguousarray(img[::-1])]
    p = codec.CodecParams(codec=codec_id, W=16 if codec_id == 11 else 12,
                          T=0, R=0, strict=strict)
    blobs = archive.encode_pages(pages, p, device="cpu")
    for blob, page in zip(blobs, pages):
        np.testing.assert_array_equal(codec.decode(blob), page)
    if codec_id != 11:
        jp = jcodec.CodecParams(codec=codec_id, W=12, T=0, R=0, strict=strict)
        assert blobs == jarchive.encode_pages(pages, jp)
        for blob, page in zip(blobs, pages):
            np.testing.assert_array_equal(jcodec.decode(blob), page)


@pytest.mark.parametrize("codec_id", [1, 11, 13])
def test_host_encode_refuses_other_codecs(codec_id):
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    with pytest.raises(ValueError, match="codecs 4/6/7/8 only"):
        compress.host_encode(img, codec.CodecParams(codec=codec_id, W=12))
