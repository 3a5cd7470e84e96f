"""Codecs 4 and 7 in causal mode through the device encoder on the CPU
(the plain K1 and K4 with the complement trick off, then native
``bic_decide_pack``) against the JAX package's ``compress.encode`` and the
native host encoder, byte for byte; and the archive of a causal codec-4/6/7
corpus, which the port could not write before (it sent those pages to the
codec-8 batch encoder), against JAX's ``archive.encode_pages``."""

import os

import numpy as np
import pytest
import torch

from binary_image_compression_tpu.models import archive as jarchive
from binary_image_compression_tpu.models import codec as jcodec
from binary_image_compression_tpu.models import compress as jcompress
from binary_image_compression_tpu_torch import native
from binary_image_compression_tpu_torch.models import archive, codec, compress
from binary_image_compression_tpu_torch.ops import decide
from binary_image_compression_tpu_torch.utils import pnm
from binary_image_compression_tpu_torch.utils.profiling import PipelineProfile

FIX = os.path.join(os.path.dirname(__file__), "fixtures")


def _params(codec_id, W, R):
    kw = dict(codec=codec_id, W=W, R=R, strict=False)
    return codec.CodecParams(**kw), jcodec.CodecParams(**kw)


@pytest.mark.parametrize("codec_id", [4, 7])
@pytest.mark.parametrize("image,W,R", [
    ("text64.pbm", 8, 32),       # K1 and the field finish
    ("noise96x80.pbm", 64, 64),  # K4 and the dense finish
    ("text64.pbm", 16, 8)])      # R < W: the native host encoder
def test_encode_equals_jax_device_and_host(monkeypatch, image, W, R,
                                           codec_id):
    img = pnm.read_pbm(os.path.join(FIX, image))
    p, jp = _params(codec_id, W, R)
    # K2 is not on this path: the modes are decided in bic_decide_pack
    monkeypatch.setattr(decide, "decide_modes", None)
    prof = PipelineProfile()
    blob = compress.encode(img, p, device="cpu", profile=prof)
    assert blob == jcompress.encode(img, jp)
    assert blob == jcodec.encode(img, jp)
    np.testing.assert_array_equal(codec.decode(blob), img)
    np.testing.assert_array_equal(jcodec.decode(blob), img)
    want = [] if R < W else ["grid_prep", "device_analysis", "native_pack"]
    assert list(prof.stages) == want
    assert all(st.calls == 1 for st in prof.stages.values())


def test_fetched_analysis_and_assembly_equal_jax():
    """``fetch_analysis`` returns JAX's ``encode_analyze`` arrays, and
    native ``bic_decide_pack`` decides the modes the host replay decides
    and writes JAX's ``_assemble`` stream, for each codec id."""
    import jax
    import jax.numpy as jnp
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    W, R = 8, 32
    kw = dict(W=W, R=R, T_thresh=0, rows=64, cols=64)
    want = jax.device_get(jcompress.encode_analyze(
        jnp.asarray(img.astype(np.int8)), invert=False, **kw))
    got = compress.fetch_analysis(compress.encode_analyze(
        torch.from_numpy(img[None]), invert=False, **kw))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k][0], np.asarray(v), err_msg=k)
    out = {k: v[0] for k, v in got.items()}
    for cid in (4, 7, 8):
        p = codec.CodecParams(codec=cid, W=W, R=R, strict=False)
        hdr = codec._header(p, 64, 64, codec.image_crc(img))
        blob, mode = native.decide_pack(
            hdr, W * W, cid, out["weights4"], out["has_cands"],
            out["idx_len"], out["inv"], out["rank"], out["residual4"])
        assert blob == jcompress._assemble(out, hdr, W * W, 64, cid)
        np.testing.assert_array_equal(
            mode, compress._decide_modes(out, W * W, cid)[0])


def test_decide_pack_raises_instead_of_a_fallback():
    z = np.zeros((2, 4), np.int32)
    with pytest.raises(RuntimeError, match="bic_decide_pack"):
        # one residual word cannot hold M = 64 bits
        native.decide_pack(b"", 64, 4, z, np.ones(2), np.ones(2),
                           np.zeros(2), np.zeros(2),
                           np.zeros((2, 4, 1), np.uint32))
    with pytest.raises(ValueError, match="decide_pack takes"):
        native.decide_pack(b"", 64, 4, z[:1], np.ones(2), np.ones(2),
                           np.zeros(2), np.zeros(2),
                           np.zeros((2, 4, 2), np.uint32))


@pytest.mark.parametrize("codec_id", [4, 6, 7])
def test_archive_of_a_causal_corpus_equals_jax(codec_id):
    """A two-page causal corpus of codec 4, 6 or 7 goes to ``codec.encode``
    page by page, as in JAX (archive.py:57-76); the parent sent it to the
    codec-8 batch encoder, which raised."""
    img = pnm.read_pbm(os.path.join(FIX, "text64.pbm"))
    pages = [img, np.ascontiguousarray(img[::-1])]
    p, jp = _params(codec_id, 8, 32)
    blobs = archive.encode_pages(pages, p, device="cpu")
    assert blobs == jarchive.encode_pages(pages, jp)
    arc = archive.encode_archive(pages, p, device="cpu")
    for i, page in enumerate(pages):
        np.testing.assert_array_equal(archive.decode_page(arc, i), page)


def test_device_encoder_refuses_host_codecs_and_strict():
    img = np.zeros((32, 32), dtype=bool)
    for cid in (1, 2, 6, 12):
        with pytest.raises(ValueError, match="codec 6 and the host codecs"):
            compress.encode(img, codec.CodecParams(codec=cid, strict=False),
                            device="cpu")
    with pytest.raises(ValueError, match="codecs 8 in causal"):
        compress.encode_batch(img[None], codec.CodecParams(codec=4,
                                                           strict=False),
                              device="cpu")
    with pytest.raises(ValueError, match="encode_strict"):
        compress.encode(img, codec.CodecParams(codec=7, strict=True),
                        device="cpu")
